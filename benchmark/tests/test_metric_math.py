"""The metric arithmetic: the scan's add count against the lanes x K of
the scan launches a prove makes, the idle share and gaps from a synthetic
trace, and the window rates."""

from __future__ import annotations

import json

import torch

from benchmark import idle, scanroof, trace
from benchmark.harness import Run, breakdown, reader

torch.set_num_threads(1)


def _run(**kw):
    base = dict(workload="w", entry="prove", setup_s=1.0, ops=[],
                window_s=0.0, peak_bytes=0, plan=None, sizes={})
    base.update(kw)
    return Run(**base)


def test_scan_adds_equal_the_launches_of_the_plan(monkeypatch):
    """Every k_scan launch covers lanes x K entries; over a prove that is
    2 x ceil(128/c) windows x (4 G1 rows | 1 G2 row) x nmax entries, of
    which the (0, 0) entries past each row's end are not counted."""
    from rapidsnark_tpu_torch.ops import fused
    from rapidsnark_tpu_torch.prover import Prover
    from benchmark import keygen
    from benchmark.circuits import sqchain
    from benchmark.entries import zkey_of
    key = keygen.make_key(sqchain.coo(3, 20), "m:1", "cpu")
    gen = torch.Generator("cpu")
    gen.manual_seed(1)
    wit = sqchain.witness(3, 20, gen, "cpu")
    prover = Prover(zkey_of(key), device="cpu")
    seen = {"g1": 0, "g2": 0}
    real = fused.scan_cols_packed

    def counting(curve, acc, cols, sign):
        k = "g2" if cols.shape[-2] == 4 else "g1"
        seen[k] += cols.shape[0] * acc[..., 0, 0].numel()   # K x lanes
        return real(curve, acc, cols, sign)

    monkeypatch.setattr(fused, "scan_cols_packed", counting)
    prover.prove(wit, 1, 2)
    plan = {"c": prover.c_bits, "nmax": prover.nmax}
    nwin = -(-128 // plan["c"])
    assert seen["g1"] == 2 * nwin * 4 * prover.nmax
    assert seen["g2"] == 2 * nwin * prover.nmax
    sizes = {"domain": key.domain, "n_vars": key.n_vars, "n_public": 1}
    pad_g1 = 4 * prover.nmax - (key.domain + 3 * key.n_vars - 2)
    assert scanroof.adds("g1", plan, sizes) == seen["g1"] - 2 * nwin * pad_g1
    assert scanroof.adds("g2", plan, sizes) == \
        seen["g2"] - 2 * nwin * (prover.nmax - key.n_vars)


def _trace_file(tmp_path, card, spans):
    evs = [{"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d}
           for n, c, ts, d in card]
    evs += [{"ph": "X", "cat": "user_annotation", "name": f"{trace.OP_SPAN}.{i}",
             "ts": s, "dur": t - s} for i, (s, t) in enumerate(spans)]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    return str(p)


def test_idle_share_and_gaps_from_a_synthetic_trace(tmp_path):
    card = [("spin_kernel", "kernel", 0, 100),            # the lead
            ("k_scan_g1(unsigned int const*)", "kernel", 1000, 300),
            ("Memcpy HtoD", "gpu_memcpy", 1200, 200),     # overlaps
            ("k_scan_g2(x)", "kernel", 1600, 200),
            ("k_add_g1(y)", "kernel", 2100, 300)]
    path = _trace_file(tmp_path, card, [(900, 1900), (2000, 2500)])
    got = trace.read(path, card=True)
    assert [e[0] for e in got["card"]][0].startswith("k_scan_g1")
    lo, hi = got["ops"][0][0], got["ops"][-1][1]
    busy = trace.busy_union(got["card"], lo, hi)
    assert busy == [(1000, 1400), (1600, 1800), (2100, 2400)]
    got.update(window_s=(hi - lo) * 1e-6,
               busy_s=sum(t - s for s, t in busy) * 1e-6, busy=busy)
    run = _run(traced=dict(got, records=[{}, {}]))
    assert abs(idle.pct(run) - 100 * (1 - 900 / 1600)) < 1e-9
    recs = [{"phases": {"front": 200e-6, "msms": 600e-6, "host": 200e-6}},
            {"phases": {"front": 100e-6, "msms": 300e-6, "host": 100e-6}}]
    from benchmark.entries import prove
    bd = breakdown(got, recs, object.__new__(prove.Entry))
    assert bd["device_ops"][0] == ["k_scan_g1", 300e-6]
    # 900-1000 in the first op's front, 1400-1600 in its msms, 1800-2100
    # between the ops, 2400-2500 in the second op's host
    got_gaps = [[lab, round(g * 1e6)] for lab, g in bd["idle_gaps"]]
    assert got_gaps == [["between ops", 300], ["msms", 200], ["front", 100],
                        ["host", 100]]


def test_a_trace_without_its_lead_raises(tmp_path):
    path = _trace_file(tmp_path, [("k", "kernel", 10, 5)], [(0, 20)])
    try:
        trace.read(path, card=True)
    except RuntimeError as e:
        assert "lead" in str(e)
    else:
        raise AssertionError("a trace without its lead was read")


def test_window_rates_and_span_means():
    ops = [{"t0": 0.0, "t1": 1.0, "phases": {"front": 0.1, "msms": 0.8,
                                             "host": 0.1, "total": 1.0}},
           {"t0": 1.0, "t1": 3.0, "phases": {"front": 0.3, "msms": 1.6,
                                             "host": 0.1, "total": 2.0}}]
    run = _run(ops=ops, window_s=3.0)
    assert reader("prove_s")(run) == 1.5
    assert reader("cold_prove_s")(run) is None
    assert abs(reader("front_s")(run) - 0.2) < 1e-12
    cold = [dict(o, t1=o["t0"] + o["phases"]["total"] + 0.5,
                 setup_phases={"a": 0.2, "b": 0.1}) for o in ops]
    run = _run(entry="cli", ops=cold, window_s=3.0)
    assert reader("cold_prove_s")(run) == 1.5
    assert reader("prove_s")(run) is None
    assert abs(reader("cold.init_s")(run) - 0.3) < 1e-12
    assert abs(reader("cold.prove_s")(run) - 1.5) < 1e-12
    assert abs(reader("cold.io_s")(run) - 0.2) < 1e-12
    assert reader("device_peak_gb")(_run(peak_bytes=2_500_000_000)) == 2.5
    assert reader("device_peak_gb")(_run()) is None
    assert reader("scan_g1.roofline_pct")(run) is None
