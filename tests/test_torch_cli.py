"""The port's CLI contract, package isolation, device policy and the
on-card fixture generator's bytes (all on the CPU)."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from rapidsnark_tpu_torch import cli, device as D, fixtures
from rapidsnark_tpu_torch.io.zkey import read_zkey, write_zkey, zkey_to_ref
from rapidsnark_tpu_torch.io.wtns import write_wtns
from rapidsnark_tpu_torch.ref import setup as S
from rapidsnark_tpu_torch.ref.groth16 import Proof, verify

from conftest import FIXTURES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "rapidsnark_tpu_torch")

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def test_cli_usage_error(capsys):
    assert cli.main([]) == 255
    assert "Usage: prover" in capsys.readouterr().err


def test_cli_wrong_wtns_curve(tmp_path, capsys):
    bad = str(tmp_path / "bad.wtns")
    write_wtns(bad, [1, 2, 3], prime=2 ** 255 - 19)
    rc = cli.main([os.path.join(FIXTURES, "multiplier.zkey"), bad,
                   str(tmp_path / "p.json"), str(tmp_path / "pub.json")])
    assert rc == 255
    assert "different wtns curve" in capsys.readouterr().err


def test_cli_null_publics(tmp_path, monkeypatch):
    """No public signals -> public.json is the bare word null; a given
    (r, s) reaches Prover.prove, whose proof for it is proof.json; the
    Prover handed out holds the reads' and the writes' spans."""
    from rapidsnark_tpu_torch import prover as PR
    monkeypatch.setattr(
        PR.Prover, "prove", lambda self, w, r=None, s=None: (
            Proof(a=(r, s), b=((1, 2), (3, 4)), c=(5, 6)), []))
    pub = tmp_path / "pub.json"
    out = []
    cli.run_prove(os.path.join(FIXTURES, "multiplier.zkey"),
                  os.path.join(FIXTURES, "multiplier.wtns"),
                  str(tmp_path / "p.json"), str(pub), device="cpu",
                  prover_out=out, r=11, s=12)
    assert pub.read_text() == "null"
    assert json.loads((tmp_path / "p.json").read_text()) == \
        Proof(a=(11, 12), b=((1, 2), (3, 4)), c=(5, 6)).to_json_dict()
    phases = out[0].last_phases
    assert {"io.read_zkey", "io.read_wtns", "io.write"} <= set(phases)
    assert all(phases[k] > 0 for k in ("io.read_zkey", "io.read_wtns",
                                       "io.write"))


def test_cli_prove_in_subprocess_without_jax(tmp_path):
    """A CPU prove through the CLI's run_prove in a fresh interpreter:
    the artifacts pairing-verify, and jax was never imported."""
    proof_p, pub_p = tmp_path / "proof.json", tmp_path / "public.json"
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from rapidsnark_tpu_torch import cli\n"
        "cli.run_prove(*sys.argv[1:], device='cpu')\n"
        "print('JAX' if 'jax' in sys.modules else 'NOJAX')\n" % REPO)
    env = dict(os.environ, RSTPU_WINDOW_BITS="4", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", code,
         os.path.join(FIXTURES, "multiplier.zkey"),
         os.path.join(FIXTURES, "multiplier.wtns"),
         str(proof_p), str(pub_p)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1:] == ["NOJAX"], out.stderr
    pj = json.loads(proof_p.read_text())
    assert pj["protocol"] == "groth16"
    assert pj["pi_a"][2] == "1" and pj["pi_b"][2] == ["1", "0"]
    pub = json.loads(pub_p.read_text())
    assert all(isinstance(v, str) for v in pub)
    proof = Proof(a=(int(pj["pi_a"][0]), int(pj["pi_a"][1])),
                  b=((int(pj["pi_b"][0][0]), int(pj["pi_b"][0][1])),
                     (int(pj["pi_b"][1][0]), int(pj["pi_b"][1][1]))),
                  c=(int(pj["pi_c"][0]), int(pj["pi_c"][1])))
    zk = read_zkey(os.path.join(FIXTURES, "multiplier.zkey"))
    assert verify(zkey_to_ref(zk), proof, [int(v) for v in pub])


def _sources():
    """Repo-relative paths of the port's modules and chip_smoke.py."""
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), REPO)
    yield "chip_smoke.py"


def _imports(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(_sources()))
def test_no_jax_or_jax_package_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "rapidsnark_tpu"), (path, name)


def test_default_device_is_cuda_and_raises_without_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        D.resolve()
    from rapidsnark_tpu_torch.prover import Prover
    with pytest.raises(RuntimeError, match="CUDA"):
        Prover(read_zkey(os.path.join(FIXTURES, "multiplier.zkey")))
    assert D.resolve("cpu").type == "cpu"


def test_wrappers_refuse_cpu_kernel_checks():
    """Wrapper-side checks run before any launch: a CPU tensor is not a
    kernel operand."""
    import torch
    with pytest.raises(ValueError, match="CUDA"):
        D.require(torch.zeros(4, 8, dtype=torch.int32), "x")


def test_fixture_generator_bytes_match_setup(tmp_path):
    """fixtures.generate at 2^6 writes the bytes of ref setup +
    write_zkey / write_wtns for the same seed."""
    zpath, wpath = fixtures.generate(6, str(tmp_path / "gen"), device="cpu")
    steps = (1 << 6) - 2
    zk = S.setup(S.sqchain_r1cs(steps), seed="bench-6")
    write_zkey(str(tmp_path / "ref.zkey"), zk)
    write_wtns(str(tmp_path / "ref.wtns"), S.sqchain_witness(steps, 3))
    assert open(zpath, "rb").read() == open(tmp_path / "ref.zkey",
                                            "rb").read()
    assert open(wpath, "rb").read() == open(tmp_path / "ref.wtns",
                                            "rb").read()
