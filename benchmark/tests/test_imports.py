"""What the benchmark runs loads no `jax`, `jaxlib`, `flax` or
`rapidsnark_tpu` (top-level names compared whole: the port,
`rapidsnark_tpu_torch`, is the system under test), and the reference
loads nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from cells import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rapidsnark_tpu"}


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    bench = os.path.join(ROOT, "benchmark")
    for d, _, fs in os.walk(bench):
        if os.sep + "tests" in d:
            continue
        for f in fs:
            if f.endswith(".py"):
                got = _imports(os.path.join(d, f)) & FORBIDDEN
                assert not got, (f, got)


def _modules_after(code: str) -> set:
    proc = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(eval(proc.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    mods = _modules_after(
        "import benchmark.harness, benchmark.run\n"
        "import rapidsnark_tpu_torch.prover, rapidsnark_tpu_torch.cli\n"
        "from benchmark import keygen\n"
        "from benchmark.circuits import sqchain\n"
        "keygen.make_key(sqchain.coo(1, 14), 's', 'cpu')")
    assert not mods & FORBIDDEN
    assert "rapidsnark_tpu_torch" in mods


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules_after(
        "from benchmark import reference, keygen\n"
        "from benchmark.circuits import sqchain\n"
        "import torch\n"
        "coo = sqchain.coo(1, 14)\n"
        "k = keygen.make_key(coo, 's', 'cpu')\n"
        "g = torch.Generator('cpu'); g.manual_seed(1)\n"
        "w = sqchain.witness(1, 14, g, 'cpu')\n"
        "reference.Reference(coo, k.toxic, 'cpu').proof(w, 1, 2)")
    assert not mods & (FORBIDDEN | {"rapidsnark_tpu_torch"})
