"""The MSM scan kernels' share of their roofline in a traced window.

The least time is the mixed adds that the prove's plan needs, each at
frozen/bounds.scan_add_imads multiply-adds, at the card's IMAD peak. With
GLV every scalar is two 128-bit halves, so a point of a row is 2 entries
in each of ceil(128 / c) windows; the G1 rows are h (domain entries), a
and b1 (n_vars each) and c (n_vars - n_public - 1); G2 has one row of
n_vars. Entries past a row's end are (0, 0) points the kernel skips, so
they are not counted. The kernel's time is the sum of its launches'
durations in the trace, a proof."""

from __future__ import annotations

from .frozen.bounds import IMAD_PER_S, scan_add_imads

KERNEL = {"g1": "k_scan_g1", "g2": "k_scan_g2"}


def adds(curve: str, plan: dict, sizes: dict) -> int:
    nwin = -(-128 // plan["c"])
    nv, npub = sizes["n_vars"], sizes["n_public"]
    if curve == "g1":
        pts = sizes["domain"] + 2 * nv + (nv - npub - 1)
    else:
        pts = nv
    return 2 * pts * nwin


def share(run, curve: str):
    t = run.traced
    if not t or "busy_s" not in t or not t["records"] or not run.plan:
        return None
    dur = sum(d for name, cat, ts, d in t["card"]
              if cat == "kernel" and name.startswith(KERNEL[curve]))
    if not dur:
        return None
    per_op = dur * 1e-6 / len(t["records"])
    least = adds(curve, run.plan, run.sizes) * scan_add_imads(curve) \
        / IMAD_PER_S
    return 100.0 * least / per_op
