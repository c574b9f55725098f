"""A tiny cell runs end to end through `python -m benchmark.run` on the
CPU, and a configuration, a traffic mix and a metric added as new files
and entries are found and run with no existing file edited."""

from __future__ import annotations

import hashlib
import json
import os

import pytest

from cells import CLI, WARM, copy_with_tiny, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _hashes(root: str) -> dict:
    out = {}
    for d, _, fs in os.walk(os.path.join(root, "benchmark")):
        for f in fs:
            if not f.endswith(".pyc"):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_tiny_warm_cell_end_to_end(tmp_path):
    where = copy_with_tiny(str(tmp_path), {"warm": WARM})
    rc, out, err = run_cell(where, "tiny.warm")
    assert rc == 0, err[-3000:]
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"prove_s", "setup_s"}
    assert out["metrics"]["prove_s"]["unit"] == "s"
    assert out["checks"] == {"failed_ops": {"value": 0, "limit": 0},
                             "wrong_proofs": {"value": 0, "limit": 0}}
    assert err.strip().splitlines()[-1] == "check wrong_proofs 0 limit 0"


def test_tiny_cli_cell_end_to_end(tmp_path):
    where = copy_with_tiny(str(tmp_path), {"cli": CLI})
    rc, out, err = run_cell(where, "tiny.cli", seconds=0.1)
    assert rc == 0, err[-3000:]
    assert out["correct"] is True
    assert set(out["metrics"]) == {"cold_prove_s", "setup_s"}
    assert set(out["checks"]) == {"failed_ops", "public_mismatch",
                                  "unverified_proofs"}


SERVED = '''"""A test's entry: the warm prove under a name of its own."""
from benchmark.entries.prove import Entry  # noqa: F401
'''

P95 = '''def read(run):
    lat = sorted(r["t1"] - r["arrival"] for r in run.ops)
    return lat[-(-95 * len(lat) // 100) - 1] if lat else None
'''


@pytest.mark.parametrize("mix", [
    dict(WARM, clients=2),
    dict(WARM, loop="open", rate_per_s=4.0, arrivals="fixed",
         entry="served"),
], ids=["closed-two-clients", "open-loop-new-entry"])
def test_new_config_mix_entry_and_metric_are_found_as_files(tmp_path, mix):
    """A cell with its own configuration, a mix the generator drives in
    another way (two clients; open-loop arrivals through an entry of its
    own) and a latency metric, added as files and entries only."""
    where = str(tmp_path)
    copy_with_tiny(where, {}, name="tiny2")
    before = _hashes(where)
    bench = os.path.join(where, "benchmark")
    with open(os.path.join(bench, "traffic", "mix2.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "entries", "served.py"), "w") as f:
        f.write(SERVED)
    with open(os.path.join(bench, "metrics", "request_p95_s.py"), "w") as f:
        f.write(P95)
    spec_path = os.path.join(where, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "tiny2.mix2", "config": "tiny2",
                              "traffic": "mix2", "chips": 1,
                              "why": "tests"})
    spec["end_to_end"].append({"name": "request_p95_s", "unit": "s",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny2.mix2"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    rc, out, err = run_cell(where, "tiny2.mix2", seconds=1.0)
    assert rc == 0, err[-3000:]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= (2 if mix["loop"] == "closed" else 3)
    assert set(out["metrics"]) == {"setup_s", "request_p95_s"}
    assert out["metrics"]["request_p95_s"]["value"] > 0
    after = _hashes(where)
    assert {k: v for k, v in after.items() if k in before} == before


def test_unknown_cell_and_missing_card_print_no_result(tmp_path):
    where = copy_with_tiny(str(tmp_path), {"warm": WARM})
    rc, out, err = run_cell(where, "nope.warm")
    assert rc != 0 and out is None and "no workload" in err
    import subprocess
    import sys
    from cells import ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "tiny.warm",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=where, env=dict(os.environ, PYTHONPATH=ROOT,
                            CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_checkout_without_the_port_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark: no port to
    import, so no result (on the CPU the harness is asked past its look
    for a card)."""
    import subprocess
    import sys
    where = copy_with_tiny(str(tmp_path), {"warm": WARM})
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "tiny.warm",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
        cwd=where, env=dict(os.environ, PYTHONPATH=""),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
