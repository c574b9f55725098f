"""The readers of the port's spans inside a prove: a value where the
records hold the spans, None where they do not (a --trace 0 run, the
other entry, or a port without those spans)."""

from __future__ import annotations

import pytest

from benchmark.harness import Run, load_spec, reader

STAGES = ("prep", "sort", "gather", "scan", "buckets")
WARM = ["front.upload_s"] + [f"msms.{s}_s" for s in STAGES]
COLD = ["cold.read_s", "cold.write_s", "cold.table_copy_s"]


def _run(entry, ops=(), traced=None):
    return Run(workload="w", entry=entry, setup_s=1.0, ops=list(ops),
               window_s=1.0, peak_bytes=0, plan=None, sizes={},
               traced=traced)


def _warm_phases(k: float) -> dict:
    """A traced proof's last_phases: the coarse spans and those inside."""
    got = {"front": 0.2 * k, "front.upload": 0.08 * k, "msms": 0.8 * k,
           "host": 0.05 * k, "total": 1.05 * k}
    got.update({f"msms.{s}": (i + 1) * 0.01 * k
                for i, s in enumerate(STAGES)})
    return got


def _cold_op(k: float) -> dict:
    return {"t0": 0.0, "t1": 0.7 * k,
            "phases": {"front": 0.02 * k, "msms": 0.08 * k,
                       "host": 0.01 * k, "total": 0.11 * k,
                       "io.read_zkey": 0.02 * k, "io.read_wtns": 0.01 * k,
                       "io.write": 0.003 * k},
            "setup_phases": {"table_stage": 0.2 * k, "table_copy": 0.1 * k,
                             "g2_rescale": 0.01 * k}}


def test_the_new_metrics_are_declared_on_their_cells():
    spec = {m["name"]: m for m in load_spec()["per_layer"]}
    for name in WARM + COLD:
        m = spec[name]
        assert m["source"] == "program_span" and m["unit"] == "s"
        assert m["workloads"] == (["d24.warm"] if name in WARM
                                  else ["d20.cli"])


@pytest.mark.parametrize("name", WARM)
def test_a_warm_reader_averages_the_traced_proofs(name):
    key = name[:-2]
    recs = [{"phases": _warm_phases(1.0)}, {"phases": _warm_phases(3.0)}]
    window = [{"phases": {"front": 9.0, "msms": 9.0}}]   # spans off
    got = reader(name)(_run("prove", window, dict(records=recs)))
    assert got == pytest.approx(2 * _warm_phases(1.0)[key])
    # a --trace 0 run; the parent's port, whose records lack the span;
    # the cli entry, whose traced records hold it too
    assert reader(name)(_run("prove", window)) is None
    bare = [{"phases": {"front": 0.2, "msms": 0.8}}]
    assert reader(name)(_run("prove", window, dict(records=bare))) is None
    assert reader(name)(_run("cli", [_cold_op(1.0)],
                             dict(records=recs))) is None


@pytest.mark.parametrize("name,keys", [
    ("cold.read_s", ("phases", "io.read_zkey", "io.read_wtns")),
    ("cold.write_s", ("phases", "io.write")),
    ("cold.table_copy_s", ("setup_phases", "table_copy"))])
def test_a_cold_reader_averages_the_window(name, keys):
    table, *names = keys
    ops = [_cold_op(1.0), _cold_op(2.0)]
    want = sum(_cold_op(1.5)[table][k] for k in names)
    assert reader(name)(_run("cli", ops)) == pytest.approx(want)
    # the parent's port: no io spans, table_upload in one piece
    old = [{"t0": 0.0, "t1": 0.7,
            "phases": {"front": 0.02, "msms": 0.08, "host": 0.01,
                       "total": 0.11},
            "setup_phases": {"table_upload": 0.3, "g2_rescale": 0.01}}]
    assert reader(name)(_run("cli", old)) is None
    assert reader(name)(_run("cli", [])) is None
    warm = [{"phases": _warm_phases(1.0)}]
    assert reader(name)(_run("prove", warm, dict(records=warm))) is None


def test_the_split_set_up_keeps_the_old_sums():
    """table_stage + table_copy take table_upload's place in one sum:
    cold.init_s and cold.io_s read the same whichever the port."""
    new = _cold_op(1.0)
    old = dict(new, setup_phases={"table_upload": 0.3, "g2_rescale": 0.01})
    for name in ("cold.init_s", "cold.io_s"):
        assert reader(name)(_run("cli", [new])) == \
            pytest.approx(reader(name)(_run("cli", [old])))
