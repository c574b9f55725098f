"""The d24.bits cell's pieces: the readers of the port's front.acc span
and live-digit counts, and the d24sha configuration's stated sizes."""

from __future__ import annotations

import json
import os

import pytest

from benchmark.circuits import sha256
from benchmark.harness import ROOT, Run, load_spec, reader

NEW = ("front.acc_s", "msms.live_pct")


def _run(entry, ops=(), traced=None):
    return Run(workload="w", entry=entry, setup_s=1.0, ops=list(ops),
               window_s=1.0, peak_bytes=0, plan=None, sizes={},
               traced=traced)


def _phases(k: float, live: int, entries: int) -> dict:
    return {"front": 0.2 * k, "front.upload": 0.08 * k,
            "front.acc": 0.002 * k, "msms": 0.8 * k, "host": 0.05 * k,
            "total": 1.05 * k, "count.msms.live": live,
            "count.msms.entries": entries}


def test_the_new_metrics_are_declared_on_both_warm_cells():
    spec = load_spec()
    per = {m["name"]: m for m in spec["per_layer"]}
    for name, unit, better in (("front.acc_s", "s", "lower"),
                               ("msms.live_pct", "%", "higher")):
        m = per[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == \
            (unit, better, "program_span", "prove_s")
        assert m["workloads"] == ["d24.warm", "d24.bits"]
    cell = next(w for w in spec["workloads"] if w["name"] == "d24.bits")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("d24sha", "warm", 1)


def test_front_acc_reader():
    recs = [{"phases": _phases(1.0, 1, 2)}, {"phases": _phases(3.0, 1, 2)}]
    window = [{"phases": {"front": 9.0, "msms": 9.0}}]    # spans off
    read = reader("front.acc_s")
    assert read(_run("prove", window, dict(records=recs))) == \
        pytest.approx(0.004)
    bare = [{"phases": {"front": 0.2, "msms": 0.8}}]      # the parent's
    assert read(_run("prove", window, dict(records=bare))) is None
    assert read(_run("prove", window)) is None            # --trace 0
    assert read(_run("cli", window, dict(records=recs))) is None


def test_live_pct_reader():
    recs = [{"phases": _phases(1.0, 200, 1000)},
            {"phases": _phases(1.0, 240, 1000)}]
    window = [{"phases": {"front": 9.0, "msms": 9.0}}]
    read = reader("msms.live_pct")
    assert read(_run("prove", window, dict(records=recs))) == \
        pytest.approx(22.0)
    bare = [{"phases": {"front": 0.2, "msms": 0.8, "msms.sort": 0.03}}]
    assert read(_run("prove", window, dict(records=bare))) is None
    assert read(_run("prove", window)) is None
    assert read(_run("cli", window, dict(records=recs))) is None


def test_d24sha_states_its_sizes():
    """The file's sizes are the family's at 33 lanes of 16 blocks (from
    the block templates, without building the COO), 33 lanes the most
    whose rows and 257 public rows fit 2^24."""
    spec = load_spec()
    cfg_entry = next(c for c in spec["configs"] if c["name"] == "d24sha")
    assert cfg_entry["reduced"] == [] and len(cfg_entry["source"]) <= 200
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        cfg = json.load(f)
    assert (cfg["circuit"], cfg["lanes"], cfg["steps"]) == ("sha256", 33, 16)
    n_vars, n_public, nc = sha256.sizes(33, 16)
    assert (cfg["n_vars"], cfg["n_public"], cfg["n_constraints"]) == \
        (n_vars, n_public, nc)
    assert (nc + n_public).bit_length() == cfg["log2_domain"] == 24
    assert sha256.sizes(34, 16)[2] + n_public + 1 > 1 << 24
    assert cfg["reduced"] == []
    for key in ("messages", "optimisation", "message_bytes",
                "public_signals", "coefficient_slots"):
        assert cfg["assumed"][key]
