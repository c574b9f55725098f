"""The port's bench harness (rapidsnark_tpu_torch/bench.py) on the CPU:
the ladder's order and budget gates with fake rungs and a fake clock,
the last-line rule, a rung's stdout as the parent parses it, real rungs
on a committed fixture and on a generated one (device="cpu" explicitly),
the kernel metrics' checks and roofline shares at a tiny size, and the
harness without a card or JAX. Tolerances: exact (words, lines)."""

import json
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

from rapidsnark_tpu_torch import bench as B, tools
from rapidsnark_tpu_torch.ref import curve as RC
from rapidsnark_tpu_torch.ref.field import FQ_CTX
from rapidsnark_tpu_torch.utils.limbs import words_to_ints

from conftest import FIXTURES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def prove_line(ln):
    return B.metric_line(f"groth16_prove_latency_2^{ln}", 0.1 * ln, "s",
                         1.0, verified=True)


class Recorder(B.Emitter):
    """An Emitter that keeps its lines instead of printing them."""

    def __init__(self, budget, clock):
        super().__init__(budget, clock)
        self.printed = []

    def put(self, line):
        self.printed.append(line)
        self.last = line
        return line


def fake_ladder(monkeypatch, budget, rung_s, estimate=50.0):
    """run() with rungs that take rung_s seconds of a fake clock, each
    estimated at `estimate`, and three kernel metrics of 10 s each, gated
    at 30 s; returns the calls in order and the emitter."""
    clock, calls = Clock(), []
    em = Recorder(budget, clock)

    def runner(ln, timeout_s):
        calls.append(("rung", ln, timeout_s))
        clock.t += rung_s
        return prove_line(ln), None

    def metric(name):
        def fn():
            calls.append(("kernel", name))
            clock.t += 10
            return B.metric_line(name, 1.0, "x/s", None, roofline_pct=1.0)
        return (name, "x/s", 30.0, fn)

    monkeypatch.setattr(B, "prove_cost_estimate_s",
                        lambda ln, reps: estimate)
    B.run(em, B.Knobs(budget_s=budget), runner,
          [metric(n) for n in ("g1_msm", "g2_msm", "ntt")])
    return calls, em


def test_ladder_order_with_budget(monkeypatch):
    """Smallest rung, largest rung, the three kernel metrics, then the
    rest descending, each gated rung's timeout the budget left; the
    headline is the largest prove."""
    calls, em = fake_ladder(monkeypatch, 1000.0, 20.0)
    assert [c[1] for c in calls] == [20, 24, "g1_msm", "g2_msm", "ntt",
                                     23, 22, 21]
    assert calls[0][2] == 1000.0 and calls[5][2] == 1000 - 70
    assert [p["metric"] for p in em.printed] == [
        "groth16_prove_latency_2^20", "groth16_prove_latency_2^24",
        "g1_msm", "g2_msm", "ntt", "groth16_prove_latency_2^23",
        "groth16_prove_latency_2^22", "groth16_prove_latency_2^21"]
    assert em.head["metric"] == "groth16_prove_latency_2^24"
    assert B.ladder(24) == ([20, 24], [23, 22, 21])
    assert B.ladder(23) == ([20, 23], [22, 21])
    assert B.ladder(21) == ([20, 21], []) and B.ladder(20) == ([20], [])


@pytest.mark.parametrize("rung_s,ran,timeouts", [
    (120.0, [20, 24], [150.0, 50.0]),
    (50.0, [20, 24, "g1_msm", "g2_msm"], [150.0, 100.0])])
def test_ladder_gates_on_the_budget(monkeypatch, rung_s, ran, timeouts):
    """A 150 s budget: the ungated rungs run whatever is left (their
    timeout at least the estimate), each kernel metric only with more
    than its gate left, and the backfill rungs are SKIPPED with the
    reason."""
    calls, em = fake_ladder(monkeypatch, 150.0, rung_s)
    assert [c[1] for c in calls] == ran
    assert [c[2] for c in calls if c[0] == "rung"] == timeouts
    skipped = [p for p in em.printed if "SKIPPED" in p["metric"]]
    assert [p["metric"] for p in skipped] == [
        f"groth16_prove_SKIPPED_2^{k}" for k in (23, 22, 21)]
    assert all(p["value"] is None and "budget" in p["extra"]["reason"]
               for p in skipped)


def run_main(monkeypatch, capsys, knobs, runner=None, metrics=(),
             crash=None):
    monkeypatch.setattr(B.Knobs, "from_env", classmethod(lambda cls: knobs))
    monkeypatch.setattr(B, "rung_subprocess", runner or (
        lambda ln, t: (prove_line(ln), None)))
    monkeypatch.setattr(B, "kernel_metrics", lambda k: list(metrics))
    if crash is not None:
        real = B.run

        def crashing(em, *a):
            real(em, *a)
            raise crash
        monkeypatch.setattr(B, "run", crashing)
    rc = B.main([])
    out = capsys.readouterr()
    return rc, [json.loads(x) for x in out.out.strip().splitlines()], out.err


def test_last_line_after_a_crash(monkeypatch, capsys):
    """An escaped exception: its traceback, a bench_CRASHED line, then
    the headline (the largest prove) as the last line; rc 1."""
    rc, lines, err = run_main(monkeypatch, capsys, B.Knobs(max_logn=22),
                              crash=MemoryError("out of memory"))
    assert rc == 1 and "MemoryError" in err
    assert [x["metric"] for x in lines] == [
        "groth16_prove_latency_2^20", "groth16_prove_latency_2^22",
        "groth16_prove_latency_2^21", "bench_CRASHED",
        "groth16_prove_latency_2^22"]
    assert lines[-1] == lines[1]
    assert "out of memory" in lines[-2]["extra"]["error"]


def test_last_line_after_a_failed_rung(monkeypatch, capsys):
    """The largest rung fails: a _FAILED_ line, and the last line repeats
    the largest prove that succeeded; rc 0."""
    rc, lines, _ = run_main(
        monkeypatch, capsys, B.Knobs(max_logn=23),
        runner=lambda ln, t: (None, "RuntimeError: no card") if ln == 23
        else (prove_line(ln), None))
    assert rc == 0
    assert [x["metric"] for x in lines] == [
        "groth16_prove_latency_2^20", "groth16_prove_FAILED_2^23",
        "groth16_prove_latency_2^22", "groth16_prove_latency_2^21",
        "groth16_prove_latency_2^22"]
    assert lines[1]["value"] is None and "no card" in \
        lines[1]["extra"]["error"]


def test_last_line_with_no_metric(monkeypatch, capsys):
    """Nothing asked for: bench_no_metrics, rc 1. Everything failing:
    the last failure repeated, rc 1, no latency anywhere."""
    rc, lines, _ = run_main(monkeypatch, capsys,
                            B.Knobs(prove=False, kernels=False))
    assert rc == 1 and [x["metric"] for x in lines] == ["bench_no_metrics"]

    def broken():
        raise RuntimeError("no CUDA device available")
    rc, lines, _ = run_main(
        monkeypatch, capsys, B.Knobs(max_logn=20),
        runner=lambda ln, t: (None, "RuntimeError: no CUDA device"),
        metrics=[("g1_msm", "points/s", 0.0, broken)])
    assert rc == 1
    assert [x["metric"] for x in lines] == [
        "groth16_prove_FAILED_2^20", "g1_msm_FAILED", "g1_msm_FAILED"]
    assert all(x["value"] is None for x in lines)


def test_parse_rung_output():
    """The parent takes the child's last verified latency line; anything
    else is an error with the last line of stderr (else stdout, else
    the exit code)."""
    good = json.dumps(prove_line(21))
    assert B.parse_rung_output(f"noise\n{good}\n", "", 0) == \
        (prove_line(21), None)
    unverified = prove_line(21)
    unverified["extra"]["verified"] = False
    assert B.parse_rung_output(json.dumps(unverified), "", 0) == \
        (None, json.dumps(unverified)[-300:])
    assert B.parse_rung_output(good, "Traceback\nRuntimeError: x\n", 1) == \
        (None, "RuntimeError: x")
    assert B.parse_rung_output("", "", -9) == (None, "rc=-9")


def test_rung_on_the_committed_fixture(monkeypatch, tmp_path):
    """A real rung on the committed multiplier circuit (domain 2^2) on the
    CPU: the median of the timed proves, the proof pairing-verified, the
    Prover's configuration and phases in extra; the parent parses it."""
    monkeypatch.setenv("RSTPU_WINDOW_BITS", "4")
    monkeypatch.setenv("RSTPU_WINDOW_GROUP", "32")
    for ext in ("zkey", "wtns"):
        shutil.copy(os.path.join(FIXTURES, f"multiplier.{ext}"),
                    tmp_path / f"sqchain4.{ext}")
    line = B.prove_rung(2, 2, str(tmp_path), device="cpu")
    ex = line["extra"]
    assert line["metric"] == "groth16_prove_latency_2^2"
    assert line["unit"] == "s" and ex["verified"] is True
    assert line["value"] == statistics.median(ex["samples_s"])
    assert line["vs_baseline"] == pytest.approx(0.4 / 2 ** 14 / line["value"])
    assert (ex["c"], ex["window_group"], ex["nmax"], ex["segment"],
            ex["domain"], ex["fixture_s"]) == (4, 32, 256, 0, 4, None)
    assert {"front", "msms", "host", "total"} <= set(ex["last_phases"])
    assert set(ex["setup_phases"]) == {"table_stage", "table_copy",
                                       "g2_rescale", "coef_binning",
                                       "ntt_plan"}
    assert ex["device"] == {"platform": "cpu"}
    assert B.parse_rung_output(json.dumps(line), "", 0) == \
        (json.loads(json.dumps(line)), None)


def test_rung_generates_a_missing_fixture(monkeypatch, tmp_path):
    """A rung whose fixture is missing generates it (fixtures.generate,
    the seconds in extra.fixture_s) and proves it; no scratch directory
    is left behind."""
    monkeypatch.setenv("RSTPU_WINDOW_BITS", "4")
    monkeypatch.setenv("RSTPU_WINDOW_GROUP", "32")
    line = B.prove_rung(3, 1, str(tmp_path), device="cpu")
    assert line["metric"] == "groth16_prove_latency_2^3"
    assert line["extra"]["verified"] and line["extra"]["fixture_s"] > 0
    assert sorted(os.listdir(tmp_path)) == ["sqchain8.wtns", "sqchain8.zkey"]
    assert B.prove_cost_estimate_s(3, 1, str(tmp_path)) < \
        B.prove_cost_estimate_s(4, 1, str(tmp_path))


def test_roofline_from_the_shared_count(monkeypatch):
    """The MSM ceiling is the card's IMAD rate over the scan's mixed adds
    (tools.scan_add_imads, which chip_smoke.py's scan bound uses too); a
    share above 100 raises."""
    assert B.msm_ceiling_pts_per_sec("g1", 20) == \
        tools.IMAD_PER_S / (20 * 14 * 264)
    assert B.msm_ceiling_pts_per_sec("g2", 20) == \
        tools.IMAD_PER_S / (20 * 33 * 264)
    assert B.roofline_pct(50.0, 200.0, "x") == 25.0
    with pytest.raises(RuntimeError, match="operation count"):
        B.roofline_pct(201.0, 200.0, "x")
    monkeypatch.setattr(B, "scan_add_imads", lambda curve: 1)
    assert B.msm_ceiling_pts_per_sec("g1", 20) == tools.IMAD_PER_S / 20


def test_msm_metric_on_the_cpu():
    """bench_msm on G1 at 256 points (c = 8, one window group): the GLV
    MSM equals msm(glv=False) after affine normalisation (else it
    raises), and its roofline share is rate over the shared ceiling."""
    r = B.bench_msm("g1", 8, 1, c=8, device="cpu", window_group=16)
    assert (r["window_bits"], r["glv"], r["adds_per_point"]) == (8, True, 32)
    assert r["rate"] == 256 / r["latency_s"]
    assert r["roofline_pct"] == 100 * r["rate"] / \
        B.msm_ceiling_pts_per_sec("g1", 32)


def test_ntt_metric_on_the_cpu():
    """bench_ntt at 2^8: the coset map's output mapped back equals its
    input (else it raises); 3 x 2 x 128 x 8 butterflies a call."""
    r = B.bench_ntt(8, 2, device="cpu")
    assert len(r["samples_s"]) == 2
    assert r["rate"] == 3 * 2 * 128 * 8 / r["latency_s"]
    assert 0 < r["roofline_pct"] < 100


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_msm_points_are_multiples_of_the_generator(curve):
    """The synthetic table: 256 (G1) or 64 (G2) multiples of the
    generator in Montgomery words, tiled."""
    n, period = (600, 256) if curve == "g1" else (200, 64)
    pts = B.msm_points(curve, n)
    assert pts.shape == (n, 2 if curve == "g1" else 4, 8)
    assert np.array_equal(pts[period:2 * period], pts[:period])
    group, gen = (RC.G1, RC.G1_GEN) if curve == "g1" else (RC.G2, RC.G2_GEN)
    for k in (0, 1, period - 1):
        v = [FQ_CTX.from_mont(x) for x in words_to_ints(pts[k])]
        pt = tuple(v) if curve == "g1" else ((v[0], v[1]), (v[2], v[3]))
        assert pt == group.mul(gen, k + 1)
    sc = B.msm_scalars(n)
    assert sc.dtype == np.uint32 and int(sc[:, 7].max()) < 1 << 30


def _bench_process(code_or_args, env_extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RSTPU_")}
    env.update(env_extra)
    cmd = [sys.executable] + code_or_args
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    return out.returncode, [json.loads(x) for x in
                            out.stdout.strip().splitlines()], out


def test_harness_imports_no_jax_and_fails_without_a_card():
    """With jax and rapidsnark_tpu unimportable the harness imports and
    runs; with no card every kernel metric is _FAILED_, the last line
    repeats one, rc 1, and no latency is printed."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['rapidsnark_tpu'] = None\n"
            "from rapidsnark_tpu_torch import bench\n"
            "rc = bench.main([])\n"
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'rapidsnark_tpu.'))]\n"
            "sys.exit(rc)\n")
    rc, lines, out = _bench_process(["-c", code],
                                    {"RSTPU_BENCH_PROVE": "0",
                                     "CUDA_VISIBLE_DEVICES": ""})
    assert rc == 1, out.stderr[-2000:]
    assert [x["metric"] for x in lines] == [
        "g1_msm_FAILED", "g2_msm_FAILED", "ntt_FAILED", "ntt_FAILED"]
    assert all("CUDA" in x["extra"]["error"] for x in lines)


def test_ladder_without_a_card_prints_failed_rungs():
    """python -m rapidsnark_tpu_torch.bench on a machine with no card:
    the rung's child exits nonzero, the parent prints its _FAILED_ line
    (the child's last error line) and repeats it last; rc 1."""
    rc, lines, out = _bench_process(
        ["-m", "rapidsnark_tpu_torch.bench"],
        {"RSTPU_BENCH_MAX_LOGN": "20", "RSTPU_BENCH_KERNELS": "0",
         "CUDA_VISIBLE_DEVICES": ""})
    assert rc == 1, out.stderr[-2000:]
    assert [x["metric"] for x in lines] == ["groth16_prove_FAILED_2^20"] * 2
    assert "no CUDA device" in lines[0]["extra"]["error"]
