"""The port's side of the benchmark's per-layer metrics: every metric of
BENCHMARK.json whose source is `program_span`, read by its own reader
(benchmark/metrics/<name>.py) from records the port makes on the CPU, in
the shape benchmark/entries/ records them. A span, phase or count the
port renames or drops reads None here, where a run on the card would
write null into the metric.

The committed multiplier circuit at c = 4 and window group 32 (each
plain MSM one scan over few buckets), two operations an entry:
Prover.prove on one loaded Prover, both under the benchmark's own tracer
(benchmark/trace.py, as the harness traces its ops: spans on), and
cli.run_prove from the files, a new Prover each (spans off, as in the
benchmark's window)."""

from __future__ import annotations

import math
import os
import time

import pytest
import torch

from benchmark import trace
from benchmark.harness import Run, cell, load_spec, reader
from rapidsnark_tpu_torch import cli
from rapidsnark_tpu_torch.io.wtns import read_wtns
from rapidsnark_tpu_torch.io.zkey import read_zkey
from rapidsnark_tpu_torch.prover import Prover

from conftest import FIXTURES

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)

SPEC = load_spec()
PROGRAM_SPAN = [m for m in SPEC["per_layer"] if m["source"] == "program_span"]
KNOBS = {"RSTPU_WINDOW_BITS": "4", "RSTPU_WINDOW_GROUP": "32"}
CIRCUIT = "multiplier"
R, S = 1234567890123456789, 987654321987654321


def _prove_records(zkey, wtns, workdir):
    """entries/prove.py's op records of two traced proofs on one Prover,
    and the traced window as harness._traced returns it."""
    prover = Prover(read_zkey(zkey), device="cpu")
    witness = read_wtns(wtns).values
    path = os.path.join(workdir, "trace.json")
    recs = []
    with trace.traced(torch.device("cpu"), path):
        for i in range(2):
            with trace.op_span(i):
                t0 = time.perf_counter()
                proof, pubs = prover.prove(witness, R + i, S + i)
                t1 = time.perf_counter()
            recs.append({"t0": t0, "t1": t1, "widx": 0, "r": R + i,
                         "s": S + i, "proof": (proof.a, proof.b, proof.c),
                         "publics": pubs,
                         "phases": dict(prover.last_phases)})
    got = trace.read(path, card=False)
    got["records"], got["failed"] = recs, []
    prover.release()
    return recs, got


def _cli_records(zkey, wtns, workdir):
    """entries/cli.py's op records of two cold proves."""
    recs = []
    for i in range(2):
        proof = os.path.join(workdir, f"proof{i}.json")
        public = os.path.join(workdir, f"public{i}.json")
        out = []
        t0 = time.perf_counter()
        cli.run_prove(zkey, wtns, proof, public, device="cpu",
                      prover_out=out)
        t1 = time.perf_counter()
        recs.append({"t0": t0, "t1": t1, "widx": 0, "r": None, "s": None,
                     "proof_path": proof, "public_path": public,
                     "phases": dict(out[0].last_phases),
                     "setup_phases": dict(out[0].setup_phases)})
        out[0].release()
    return recs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """entry name -> the Run the harness would hand that entry's
    readers."""
    mp = pytest.MonkeyPatch()
    for k, v in KNOBS.items():
        mp.setenv(k, v)
    try:
        workdir = str(tmp_path_factory.mktemp("contract"))
        zkey = os.path.join(FIXTURES, f"{CIRCUIT}.zkey")
        wtns = os.path.join(FIXTURES, f"{CIRCUIT}.wtns")
        warm, traced = _prove_records(zkey, wtns, workdir)
        cold = _cli_records(zkey, wtns, workdir)
    finally:
        mp.undo()

    def run(entry, ops, traced=None):
        return Run(workload=CIRCUIT, entry=entry, setup_s=0.0, ops=ops,
                   window_s=ops[-1]["t1"] - ops[0]["t0"], peak_bytes=0,
                   plan={}, sizes={}, traced=traced)
    return {"prove": run("prove", warm, traced), "cli": run("cli", cold)}


def test_program_span_metrics_are_declared():
    assert len(PROGRAM_SPAN) >= 17
    assert {m["name"] for m in PROGRAM_SPAN} >= {
        "front_s", "msms_s", "host_s", "front.upload_s", "front.acc_s",
        "msms.live_pct", "cold.read_s", "cold.init_s"}


@pytest.mark.parametrize("metric", PROGRAM_SPAN, ids=lambda m: m["name"])
def test_a_program_span_reader_reads_the_port(metric, runs):
    """In every cell the metric lists, its reader finds a finite,
    non-negative number in the port's records (a share in (0, 100])."""
    entries = {cell(SPEC, wl)[3]["entry"] for wl in metric["workloads"]}
    assert entries
    for entry in sorted(entries):
        v = reader(metric["name"])(runs[entry])
        assert v is not None, (metric["name"], entry)
        assert math.isfinite(v) and v >= 0, (metric["name"], entry, v)
        if metric["unit"] == "%":
            assert 0 < v <= 100, (metric["name"], entry, v)
