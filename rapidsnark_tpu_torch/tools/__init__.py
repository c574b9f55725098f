"""Measurement tools of the port, run as modules
(`python -m rapidsnark_tpu_torch.tools.<name>`), on the card unless
`main(..., device="cpu")` is asked for."""

from __future__ import annotations

import time

import torch


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
