"""The port's benchmark harness: the BASELINE.md ladder as JSON lines.

    python -m rapidsnark_tpu_torch.bench            the ladder (one card)
    python -m rapidsnark_tpu_torch.bench --rung k   one prove rung

Counterpart of the root bench.py for the PyTorch/CUDA port. Every metric
is one JSON line {"metric", "value", "unit", "vs_baseline", "extra"}.
Order: the smallest prove rung, then the largest (both ungated), then
the MSM and NTT metrics (each gated on the wall budget, each
crash-proof), then the other rungs in descending order, each gated on
prove_cost_estimate_s. The last stdout line always parses and repeats
the headline: the largest prove that succeeded, else the first kernel
metric that did. An escaped exception prints its traceback, a
bench_CRASHED line, then the headline; bench_no_metrics when nothing
ran. The exit code is 1 after a crash or when no metric succeeded.

  groth16_prove_latency_2^k    the median of RSTPU_BENCH_REPS warm proves
                               of bench_fixtures/sqchain<2^k> (generated
                               on the card when missing), one child
                               process a rung (--rung k); the last proof
                               pairing-verified against the zkey's
                               verifying key, or the rung is _FAILED_
  g1_msm_points_per_sec_2^n    ops/msm.msm of 2^n G1 points (n =
                               RSTPU_BENCH_LOGN), checked against
                               msm(glv=False) on the same scalars
  g2_msm_points_per_sec_2^m    the same on G2, m = min(n, 18)
  ntt_butterflies_per_sec_2^l  ops/ntt.to_odd_coset of a (3, 2^l) stack,
                               l = min(n + 2, 22), checked by the inverse
                               map on one polynomial

vs_baseline is against the documented stand-ins (BASELINE.md, "Stand-in
derivation"): 0.4 s x 2^(k-16) a prove, 1e7 G1 points/s.
roofline_pct is a kernel metric's share of an IMAD bound on the H100
(tools.IMAD_PER_S): the MSM counts only its scan's mixed adds
(tools.scan_add_imads), the NTT one Montgomery product a butterfly and
one a coset element. A share above 100 is a bug in the count and raises.

Knobs (as the root bench.py's): RSTPU_BENCH_BUDGET_S (wall budget,
default 2800), RSTPU_BENCH_LOGN (kernel metric size, default 20),
RSTPU_BENCH_REPS (timed proves and kernel reps, default 3),
RSTPU_BENCH_WINDOW (the MSM metrics' c, default config.msm_plan's),
RSTPU_BENCH_PROVE=0 (no proves), RSTPU_BENCH_MAX_LOGN (the largest rung,
default 24), RSTPU_BENCH_KERNELS=0 (no kernel metrics),
RSTPU_BENCH_SUBPROC=0 (rungs in this process).
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from . import config, device as D, fixtures
from .tools import IMAD_PER_S, MONT_IMADS, card_line, scan_add_imads

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(HERE, "bench_fixtures")
LADDER = (20, 21, 22, 23, 24)

BASELINE_G1_MSM_PTS_PER_SEC = 1.0e7   # BASELINE.md "Stand-in derivation"
BASELINE_PROVE_S_2_16 = 0.4

# a rung's seconds on one H100 80GB HBM3 at 700 W (PERF.md §5: fixture
# generation 6.0 / 25.0 / 88.9 s, set-up 0.3 / 1.1 / 4.0 s, warm proves
# 0.16 / 0.46 / 2.07 s at 2^20 / 2^22 / 2^24), a second per row, and a
# child's start (the interpreter, torch, the card, the zkey read)
GEN_S_PER_ROW = 5.4e-6
SETUP_S_PER_ROW = 3.5e-7
PROVE_S_PER_ROW = 1.3e-7
START_S = 20.0
FIXTURE_BYTES_PER_ROW = 560       # zkey + wtns (the 2^24 zkey: 7.9 GB)
# seconds of budget a kernel metric needs before it starts
KERNEL_GATE_S = {"g1_msm": 60.0, "g2_msm": 60.0, "ntt": 30.0}


@dataclass
class Knobs:
    budget_s: float = 2800.0
    log_n: int = 20
    reps: int = 3
    window: Optional[int] = None
    prove: bool = True
    max_logn: int = 24
    kernels: bool = True
    subproc: bool = True

    @classmethod
    def from_env(cls) -> "Knobs":
        env = os.environ.get
        return cls(budget_s=float(env("RSTPU_BENCH_BUDGET_S", "2800")),
                   log_n=int(env("RSTPU_BENCH_LOGN", "20")),
                   reps=int(env("RSTPU_BENCH_REPS", "3")),
                   window=int(env("RSTPU_BENCH_WINDOW") or 0) or None,
                   prove=env("RSTPU_BENCH_PROVE", "1") != "0",
                   max_logn=int(env("RSTPU_BENCH_MAX_LOGN", "24")),
                   kernels=env("RSTPU_BENCH_KERNELS", "1") != "0",
                   subproc=env("RSTPU_BENCH_SUBPROC", "1") != "0")


def metric_line(metric, value, unit, vs_baseline, **extra) -> dict:
    return {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": vs_baseline, "extra": extra}


class Emitter:
    """Prints the metric lines and keeps the headline: the largest prove
    that succeeded, else the first kernel metric that did."""

    def __init__(self, budget_s: float, clock: Callable[[], float] =
                 time.monotonic):
        self.clock, self.budget_s = clock, budget_s
        self.t0 = clock()
        self.head, self.head_ln, self.last = None, -1, None

    def remaining(self) -> float:
        return self.budget_s - (self.clock() - self.t0)

    def put(self, line: dict) -> dict:
        print(json.dumps(line), flush=True)
        self.last = line
        return line

    def emit(self, metric, value, unit, vs_baseline, **extra) -> dict:
        return self.put(metric_line(metric, value, unit, vs_baseline,
                                    **extra))

    def headline(self, line: dict, ln: Optional[int] = None) -> None:
        if ln is not None and ln > self.head_ln:
            self.head, self.head_ln = line, ln
        elif self.head is None:
            self.head = line

    def finish(self, crashed: bool) -> int:
        """The last line (the headline, else the last line printed, else
        bench_no_metrics) and the exit code."""
        if self.last is None:
            self.emit("bench_no_metrics", None, "", None)
        else:
            print(json.dumps(self.head or self.last), flush=True)
        return 1 if crashed or self.head is None else 0


def ladder(max_logn: int) -> Tuple[List[int], List[int]]:
    """(the ungated rungs: the smallest, then the largest; the gated
    backfill, descending)."""
    sizes = [k for k in LADDER if k <= max_logn]
    return sizes[:1] + (sizes[-1:] if len(sizes) > 1 else []), \
        sizes[-2:0:-1]


def fixture_paths(ln: int, fixdir: str = FIXDIR) -> Tuple[str, str]:
    base = os.path.join(fixdir, f"sqchain{1 << ln}")
    return base + ".zkey", base + ".wtns"


def prove_cost_estimate_s(ln: int, reps: int, fixdir: str = FIXDIR) -> float:
    """A rung's wall seconds on the card: a child's start, the fixture's
    generation when it is missing, the zkey read and set-up, and the
    warm-up and timed proves."""
    rows = 1 << ln
    gen = 0.0 if all(map(os.path.exists, fixture_paths(ln, fixdir))) \
        else GEN_S_PER_ROW * rows
    return START_S + gen + rows * (SETUP_S_PER_ROW
                                   + (1 + reps) * PROVE_S_PER_ROW)


def device_info(dev: torch.device) -> dict:
    """The card's name (torch), its name and power limit (nvidia-smi) and
    the device count; {"platform": "cpu"} on the CPU."""
    if dev.type != "cuda":
        return {"platform": "cpu"}
    try:
        smi = card_line()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        smi = f"nvidia-smi failed: {e}"
    return {"platform": "gpu", "name": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi, "power_limit": smi.split(",")[-1].strip(),
            "count": torch.cuda.device_count()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_calls(fn, reps: int, dev: torch.device) -> List[float]:
    """Seconds of each of `reps` synchronised calls of fn after one
    warm-up call: CUDA events on the card, the host clock on the CPU."""
    fn()
    _sync(dev)
    out = []
    for _ in range(reps):
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize(dev)
            out.append(e0.elapsed_time(e1) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t0)
    return out


def roofline_pct(rate: float, ceiling: float, what: str) -> float:
    """rate as a percentage of its ceiling; above 100 the operation count
    behind the ceiling is wrong, and that raises."""
    pct = 100.0 * rate / ceiling
    if pct > 100.0:
        raise RuntimeError(f"{what}: {pct:.1f}% of its IMAD bound; the "
                           "operation count is wrong")
    return pct


def msm_ceiling_pts_per_sec(curve: str, adds_per_point: int) -> float:
    """The MSM's points a second if every scan mixed add ran at the
    card's IMAD rate (sort, gather and bucket extraction free)."""
    return IMAD_PER_S / (adds_per_point * scan_add_imads(curve))


# ---------------------------------------------------------------------------
# prove rungs
# ---------------------------------------------------------------------------

def ensure_fixture(ln: int, fixdir: str, device) -> Tuple[str, str,
                                                          Optional[float]]:
    """The rung's zkey and wtns, generated on `device` into fixdir when
    missing (into a scratch directory, then moved, so a cut run leaves no
    half-written fixture); (zkey, wtns, seconds generating or None).
    Raises when the disk cannot hold them."""
    zpath, wpath = fixture_paths(ln, fixdir)
    if os.path.exists(zpath) and os.path.exists(wpath):
        return zpath, wpath, None
    os.makedirs(fixdir, exist_ok=True)
    need, free = FIXTURE_BYTES_PER_ROW << ln, shutil.disk_usage(fixdir).free
    if free < need:
        raise RuntimeError(f"sqchain{1 << ln} needs ~{need} B of disk, "
                           f"{free} B free under {fixdir}")
    tmp = os.path.join(fixdir, f".gen{os.getpid()}")
    t0 = time.perf_counter()
    try:
        made = fixtures.generate(ln, tmp, device=device)
        for src, dst in zip(made, (zpath, wpath)):
            os.replace(src, dst)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return zpath, wpath, time.perf_counter() - t0


def bench_prove(zpath: str, wpath: str, reps: int, device="cuda",
                **extra) -> dict:
    """One rung's line: a Prover on `device`, one warm-up prove, `reps`
    timed proves (each ending in a synchronize), the last proof
    pairing-verified (ref/groth16.verify; a proof that fails raises);
    the value is the median. The Prover is released at the end."""
    from .io.wtns import read_wtns
    from .io.zkey import read_zkey, zkey_to_ref
    from .prover import Prover
    from .ref.groth16 import verify

    dev = D.resolve(device)
    t0 = time.perf_counter()
    zk = read_zkey(zpath)
    try:
        read_s = time.perf_counter() - t0
        vk = zkey_to_ref(zk, tables=False)
        t0 = time.perf_counter()
        prover = Prover(zk, device=dev)
        setup_s = time.perf_counter() - t0
    finally:
        zk.close()
    try:
        wit = read_wtns(wpath).values
        t0 = time.perf_counter()
        prover.prove(wit)
        _sync(dev)
        warmup_s = time.perf_counter() - t0
        D.reset_counts()
        samples = []
        for _ in range(reps):
            peaks = {}
            t0 = time.perf_counter()
            proof, publics = prover.prove(wit, peaks=peaks)
            _sync(dev)
            samples.append(time.perf_counter() - t0)
        launches = dict(D.counts)
        ln = prover.power
        if not verify(vk, proof, publics):
            raise RuntimeError(f"the proof of {os.path.basename(zpath)} "
                               "does not verify")
        value = statistics.median(samples)
        baseline_s = BASELINE_PROVE_S_2_16 * (1 << ln) / (1 << 16)
        return metric_line(
            f"groth16_prove_latency_2^{ln}", value, "s", baseline_s / value,
            verified=True, samples_s=samples, warmup_s=warmup_s,
            read_s=read_s, setup_s=setup_s,
            setup_phases=dict(prover.setup_phases),
            last_phases=dict(prover.last_phases), peaks_bytes=peaks,
            nmax=prover.nmax, segment=prover.segment, c=prover.c_bits,
            window_group=prover.window_group, plan=prover.plan._asdict(),
            n_vars=prover.n_vars,
            domain=prover.domain, launches=launches, device=device_info(dev),
            baseline="stand-in-estimate", **extra)
    finally:
        prover.release()


def prove_rung(ln: int, reps: int, fixdir: str = FIXDIR,
               device="cuda") -> dict:
    """The 2^ln rung: its fixture (generated when missing, the seconds in
    extra.fixture_s), then bench_prove."""
    dev = D.resolve(device)
    zpath, wpath, gen_s = ensure_fixture(ln, fixdir, dev)
    return bench_prove(zpath, wpath, reps, dev, fixture_s=gen_s)


def parse_rung_output(stdout: str, stderr: str, rc: int):
    """A child's rung: (its verified latency line, None), or (None, the
    error: the last line of its stderr, else of its stdout, else rc)."""
    for text in reversed(stdout.strip().splitlines()):
        try:
            line = json.loads(text)
        except ValueError:
            continue
        if rc == 0 and isinstance(line, dict) and \
                str(line.get("metric")).startswith("groth16_prove_latency") \
                and line.get("extra", {}).get("verified") is True:
            return line, None
    tail = (stderr or stdout or "").strip().splitlines()
    return None, (tail[-1][-300:] if tail else f"rc={rc}")


def rung_subprocess(ln: int, timeout_s: float):
    """One rung in a child process (a rung that fails or runs out of
    memory takes none of the others with it)."""
    cmd = [sys.executable, "-m", "rapidsnark_tpu_torch.bench", "--rung",
           str(ln)]
    try:
        out = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                             timeout=max(timeout_s, 60))
    except subprocess.TimeoutExpired:
        return None, f"subprocess timeout ({timeout_s:.0f}s)"
    return parse_rung_output(out.stdout, out.stderr, out.returncode)


# ---------------------------------------------------------------------------
# kernel metrics
# ---------------------------------------------------------------------------

def _multiples(gen, group, count: int) -> list:
    out, p = [], gen
    for _ in range(count):
        out.append(p)
        p = group.add(p, gen)
    return out


def msm_points(curve: str, n: int) -> np.ndarray:
    """n affine points as packed Montgomery words ((n, 2, 8) G1, (n, 4, 8)
    G2 in the zkey's order), uint32: 256 (G1) or 64 (G2) multiples of the
    generator, tiled. The MSM's time does not depend on the values."""
    from .ref import curve as RC
    from .ref.field import FQ_CTX
    from .utils.limbs import ints_to_words
    if curve == "g1":
        coords = [(x, y) for x, y in _multiples(RC.G1_GEN, RC.G1,
                                               min(256, n))]
    else:
        coords = [(x[0], x[1], y[0], y[1]) for x, y in
                  _multiples(RC.G2_GEN, RC.G2, min(64, n))]
    base = np.stack([ints_to_words([FQ_CTX.to_mont(v) for v in c])
                     for c in coords])
    return np.tile(base, (-(-n // base.shape[0]), 1, 1))[:n]


def msm_scalars(n: int, seed: int = 7) -> np.ndarray:
    """(n, 8) uint32 words of scalars below 2^254, as the root bench.py
    draws them (16-bit limbs from RandomState(seed), the top one masked)."""
    limbs = np.random.RandomState(seed).randint(
        0, 1 << 16, size=(n, 16)).astype(np.uint32)
    limbs[:, 15] &= 0x3FFF
    return limbs[:, 0::2] | (limbs[:, 1::2] << 16)


def _affine(tot: torch.Tensor, curve: str):
    from .prover import host_g1, host_g2
    from .utils.hostcurve import G1H, G2H
    w = tot.cpu().numpy().view(np.uint32)
    if curve == "g1":
        return [G1H.to_affine(host_g1(w[b])) for b in range(w.shape[0])]
    return [G2H.to_affine(host_g2(w[b])) for b in range(w.shape[0])]


def _i32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32)).to(dev)


def bench_msm(curve: str, log_n: int, reps: int, c: Optional[int] = None,
              device="cuda", window_group: Optional[int] = None) -> dict:
    """ops/msm.msm (the device combine) of 2^log_n points, timed over
    `reps` calls after a warm-up; the result is held against
    msm(glv=False) on the same scalars after affine normalisation.
    Returns the rate, the samples and the roofline share."""
    from .ops import glv as GLV, msm as MSM
    from .ops.curve import G1P, G2P
    dev = D.resolve(device)
    n = 1 << log_n
    pts = _i32(msm_points(curve, n)[None], dev)
    if curve == "g2":
        pts = MSM.g2_rescale_packed(pts)
    sc = _i32(msm_scalars(n)[None], dev)
    plan = config.msm_plan(n, 1, 1, D.total_memory(dev))
    c = c or plan.c
    group = window_group or config.int_env("RSTPU_WINDOW_GROUP") or plan.G
    glv = GLV.enabled()
    cv = G1P if curve == "g1" else G2P

    def run(use_glv=glv):
        return MSM.msm(cv, pts, sc, c, group, combine=True,
                       segment=plan.segment, glv=use_glv)

    samples = _time_calls(run, reps, dev)
    if _affine(run(), curve) != _affine(run(not glv), curve):
        raise RuntimeError(f"{curve} msm with glv={glv} differs from "
                           f"glv={not glv}")
    adds = (2 if glv else 1) * -(-(GLV.GLV_BITS if glv else MSM.SCALAR_BITS)
                                 // c)
    dt = statistics.median(samples)
    rate = n / dt
    del pts, sc
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"rate": rate, "latency_s": dt, "samples_s": samples,
            "window_bits": c, "window_group": group, "glv": glv,
            "adds_per_point": adds,
            "roofline_pct": roofline_pct(
                rate, msm_ceiling_pts_per_sec(curve, adds), f"{curve} msm"),
            "checked": f"equals msm(glv={not glv}) after affine "
                       "normalisation"}


def bench_ntt(log_n: int, reps: int, device="cuda") -> dict:
    """ops/ntt.to_odd_coset (the prover's coset map: an inverse and a
    forward transform, the coset multiply folded in) of a (3, 2^log_n)
    stack, timed over `reps` calls after a warm-up; butterflies/s =
    3 x 2 x N/2 x log2 N / s. Polynomial 0 of the output is mapped back
    (inverse NTT, times eta^-k, forward NTT) and must give the input."""
    from .ops import front as FRONT
    from .ops.ntt import NTTPlan, ntt, powers_mont, to_odd_coset
    from .ref.field import R_FR, fr_w
    dev = D.resolve(device)
    n = 1 << log_n
    plan = NTTPlan(log_n, dev).tensors()
    w = np.random.RandomState(3).randint(0, 1 << 32, size=(3, n, 8),
                                         dtype=np.uint64)
    w[..., 7] %= R_FR >> 224
    x = _i32(w.astype(np.uint32), dev)

    def run():
        return to_odd_coset(x, plan)

    samples = _time_calls(run, reps, dev)
    eta_inv = powers_mont(pow(fr_w(log_n + 1), -1, R_FR), n, device=dev)
    back = ntt(FRONT.fr_pointwise("mul", ntt(run()[0], plan, inverse=True),
                                  eta_inv), plan)
    if not torch.equal(back, x[0]):
        raise RuntimeError("to_odd_coset mapped back does not give its "
                           "input")
    dt = statistics.median(samples)
    butterflies = 3 * 2 * (n // 2) * log_n
    imads = (butterflies + 3 * n) * MONT_IMADS
    rate = butterflies / dt
    del x, plan, back
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"rate": rate, "latency_s": dt, "samples_s": samples,
            "roofline_pct": roofline_pct(
                rate, butterflies * IMAD_PER_S / imads, "ntt"),
            "checked": "polynomial 0 mapped back equals the input"}


ROOFLINE_NOTE = ("share of an IMAD bound: 264 IMADs a Montgomery product "
                 "at 16.7e12 IMAD/s (H100 SXM)")


def kernel_metrics(knobs: Knobs, device="cuda"):
    """[(name, unit, gate seconds, fn)]: fn() returns the metric's line."""
    msm_ln = min(knobs.log_n, knobs.max_logn)
    g2_ln = min(msm_ln, 18)
    ntt_ln = min(knobs.log_n + 2, 22)

    def msm_line(curve, ln, scale):
        def fn():
            r = bench_msm(curve, ln, knobs.reps, knobs.window, device)
            rate = r.pop("rate")
            return metric_line(
                f"{curve}_msm_points_per_sec_2^{ln}", rate, "points/s",
                scale * rate / BASELINE_G1_MSM_PTS_PER_SEC, **r,
                roofline=ROOFLINE_NOTE + ", scan mixed adds only",
                device=device_info(D.resolve(device)),
                baseline="stand-in-estimate" + (
                    "" if curve == "g1" else "; vs_baseline scales G2 adds "
                    "~3x G1"))
        return fn

    def ntt_fn():
        r = bench_ntt(ntt_ln, knobs.reps, device)
        return metric_line(f"ntt_butterflies_per_sec_2^{ntt_ln}",
                           r.pop("rate"), "butterflies/s", None, **r,
                           roofline=ROOFLINE_NOTE + ", a product a "
                           "butterfly and a coset element",
                           device=device_info(D.resolve(device)))

    return [("g1_msm", "points/s", KERNEL_GATE_S["g1_msm"],
             msm_line("g1", msm_ln, 1)),
            ("g2_msm", "points/s", KERNEL_GATE_S["g2_msm"],
             msm_line("g2", g2_ln, 3)),
            ("ntt", "butterflies/s", KERNEL_GATE_S["ntt"], ntt_fn)]


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

def run(em: Emitter, knobs: Knobs, rung_runner, metrics) -> None:
    """The ladder's order on `em`: rung_runner(ln, timeout_s) -> (line,
    error) runs one rung; `metrics` as kernel_metrics returns them."""
    order, backfill = ladder(knobs.max_logn) if knobs.prove else ([], [])

    def rung(ln: int, gated: bool) -> None:
        est = prove_cost_estimate_s(ln, knobs.reps)
        if gated and em.remaining() < est:
            em.emit(f"groth16_prove_SKIPPED_2^{ln}", None, "s", None,
                    reason=f"budget: {em.remaining():.0f}s left, the rung "
                    f"needs ~{est:.0f}s")
            return
        line, err = rung_runner(ln, em.remaining() if gated
                                else max(em.remaining(), est))
        if line is None:
            em.emit(f"groth16_prove_FAILED_2^{ln}", None, "s", None,
                    error=str(err)[:300])
            return
        em.headline(em.put(line), ln)

    for ln in order:
        rung(ln, gated=False)
    if knobs.kernels:
        for name, unit, gate, fn in metrics:
            if em.remaining() <= gate:
                continue
            try:
                line = fn()
            except Exception as e:          # a failed metric ends no run
                traceback.print_exc()
                em.emit(f"{name}_FAILED", None, unit, None,
                        error=f"{type(e).__name__}: {str(e)[:300]}")
                continue
            em.headline(em.put(line))
    for ln in backfill:
        rung(ln, gated=True)


def _in_process(knobs: Knobs):
    def runner(ln: int, timeout_s: float):
        try:
            return prove_rung(ln, knobs.reps), None
        except Exception as e:      # a failed rung ends no run
            traceback.print_exc()
            return None, f"{type(e).__name__}: {e}"
    return runner


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    knobs = Knobs.from_env()
    if "--rung" in argv:
        # one rung, one JSON line; an exception prints its traceback and
        # exits nonzero (the parent reports the failure)
        ln = int(argv[argv.index("--rung") + 1])
        print(json.dumps(prove_rung(ln, knobs.reps)), flush=True)
        return 0
    em = Emitter(knobs.budget_s)
    try:
        run(em, knobs, rung_subprocess if knobs.subproc
            else _in_process(knobs), kernel_metrics(knobs))
    except BaseException as e:
        # the last stdout line parses whatever escaped: the traceback, a
        # bench_CRASHED line and the headline; an interrupt or an exit
        # then goes on up
        traceback.print_exc()
        em.emit("bench_CRASHED", None, "", None,
                error=f"{type(e).__name__}: {str(e)[:300]}")
        rc = em.finish(crashed=True)
        if not isinstance(e, Exception):
            raise
        return rc
    return em.finish(crashed=False)


if __name__ == "__main__":
    sys.exit(main())
