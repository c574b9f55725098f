# The lead and the traced block follow rapidsnark_tpu_torch/device.py
# (_lead, traced, block_events) at commit 6caa3f5; the reading of the
# exported trace is new.
"""The traced window: torch.profiler over a block of operations, and the
card's events of that block read from the exported Chrome trace.

A profiler session can lose its first card records. So on a card a lead
runs in a warm-up step and again at the start of the active step, before
the block: a spin of about 0.27 s (a kernel named LEAD), a host-to-card
copy, LEAD_KERNELS small kernels and a short marker spin. The block's card
events are those that start after the end of the last lead spin, on the
card's own timeline; a trace with no lead spin raises, since it may have
lost the block's first records too."""

from __future__ import annotations

import contextlib
import json

import torch

LEAD = "spin_kernel"
LEAD_CYCLES = 1 << 29
LEAD_KERNELS = 64
CARD_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OP_SPAN = "benchmark.op"


def _lead(dev: torch.device) -> None:
    with torch.cuda.device(dev):
        torch.cuda._sleep(LEAD_CYCLES)
        x = torch.zeros(1 << 16, dtype=torch.int32).to(dev)
        for _ in range(LEAD_KERNELS):
            x.add_(1)
        torch.cuda._sleep(1)
    torch.cuda.synchronize(dev)


@contextlib.contextmanager
def traced(dev: torch.device, path: str):
    """Profile the block (host activity, and the card's on a card) as the
    profiler's one active step, and export it as a Chrome trace to path."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=lambda p: p.export_chrome_trace(path),
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        if dev.type == "cuda":
            _lead(dev)
        prof.step()
        if dev.type == "cuda":
            _lead(dev)
        yield prof
        prof.step()


def op_span(i: int):
    """The benchmark's span around traced operation i."""
    return torch.profiler.record_function(f"{OP_SPAN}.{i}")


def read(path: str, card: bool) -> dict:
    """{"card": [(name, cat, ts_us, dur_us)] after the lead, sorted by
    start; "ops": [(ts_us, end_us)] of the benchmark's op spans in order}.
    On a card a trace without its lead raises."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    dev, ops = [], {}
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in CARD_CATS:
            dev.append((name, cat, float(e["ts"]), float(e.get("dur", 0))))
        elif cat == "user_annotation" and name.startswith(OP_SPAN + "."):
            ops[int(name.rsplit(".", 1)[1])] = (
                float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
    if card:
        ends = [ts + d for n, c, ts, d in dev if LEAD in n]
        if not ends:
            raise RuntimeError(
                "the trace lost its lead kernels, so the block's first card "
                f"records may be lost too: {len(dev)} card events")
        start = max(ends)
        dev = [e for e in dev if e[2] >= start and LEAD not in e[0]]
    dev.sort(key=lambda e: e[2])
    return {"card": dev, "ops": [ops[i] for i in sorted(ops)]}


def busy_union(card: list, lo: float, hi: float) -> list:
    """The union of the card events' intervals, clipped to [lo, hi] (us),
    as sorted disjoint (start, end) pairs."""
    out = []
    for _, _, ts, d in sorted(card, key=lambda e: e[2]):
        s, t = max(ts, lo), min(ts + d, hi)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def idle_gaps(busy: list, lo: float, hi: float) -> list:
    """The gaps (start, end) in [lo, hi] between busy intervals."""
    gaps, cur = [], lo
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def kernel_name(name: str) -> str:
    """A card event's name without its argument list."""
    return name.split("(", 1)[0].strip()[:96]
