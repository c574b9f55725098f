"""Measurement tools of the port, run as modules
(`python -m rapidsnark_tpu_torch.tools.<name>`), on the card unless
`main(..., device="cpu")` is asked for."""

from __future__ import annotations

import subprocess
import time

import torch

# the H100 SXM's peaks behind every bound: HBM bytes a second, and 32-bit
# multiply-adds a second (132 SMs x 64 a clock x 1.98 GHz); a Montgomery
# product of 8 x 8 limbs counted as 264 of them
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
MONT_IMADS = 264


def scan_add_imads(curve: str) -> int:
    """The multiply-adds of one mixed add of the MSM's prefix scan on
    "g1" (14 Montgomery products, the relaxed law) or "g2" (33, the
    iso-twist's law, an Fq2 product counted as three): the count behind
    scan_cols_packed's bound in chip_smoke.py."""
    return {"g1": 14, "g2": 33}[curve] * MONT_IMADS


def bound_ms(nbytes, imads):
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that moves nbytes and runs imads multiply-adds."""
    tb = nbytes / HBM_BYTES_PER_S
    to = imads / IMAD_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_words(shape, modulus: int, gen: torch.Generator,
                 device) -> torch.Tensor:
    """Random residues below `modulus` (top word cut below the
    modulus's) as packed int32 words (*shape, 8), drawn on `device` from
    `gen`: point tables and scalars for the tools, whose kernels take
    the same time whatever the values (complete adders)."""
    w = torch.randint(0, 1 << 32, tuple(shape) + (8,), generator=gen,
                      dtype=torch.int64, device=device)
    w[..., 7] %= modulus >> 224
    return (w - ((w >> 31) << 32)).to(torch.int32)


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def timeit(fn, reps: int, device: torch.device, calls: int = 1) -> float:
    """Seconds per call of fn(): the least of `reps` timings of `calls`
    back-to-back calls, after one warm-up call. CUDA events on the card
    (a host clock would time the enqueue), time.perf_counter on the CPU."""
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(calls):
                fn()
            e1.record()
            torch.cuda.synchronize(device)
            times.append(e0.elapsed_time(e1) * 1e-3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append(time.perf_counter() - t0)
    return min(times) / calls


def device_time(fn, calls: int) -> tuple:
    """(ms a call on the device, method) on the card, where a narrow
    launch timed through its Python wrapper measures the host: `calls`
    calls of fn captured in one CUDA graph after a warm-up call, one
    replay to warm up, one timed by CUDA events ("graph"). Where capture
    fails (a call that synchronises with the host), the summed durations
    of the device activity torch.profiler records over `calls` eager
    calls after device.traced's lead ("profiler"). Launch counts (device.counts) are put back as they
    were: the captured or profiled calls are not the main path's."""
    from .. import device as D
    saved = dict(D.counts)
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError:
        torch.cuda.set_stream(torch.cuda.default_stream())
        torch.cuda.synchronize()
        return _profiled_ms(fn, calls, saved), "profiler"
    finally:
        D.counts.update(saved)
    graph.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / calls, "graph"


def _profiled_ms(fn, calls: int, saved: dict) -> float:
    from .. import device as D
    box = {}
    with D.traced(torch.device("cuda", torch.cuda.current_device()),
                  lambda p: box.update(evs=p.events())):
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    D.counts.update(saved)
    us = sum(e.time_range.end - e.time_range.start
             for e in D.block_events(box["evs"]))
    return us / 1e3 / calls
