# Frozen copy of the peaks and counts of rapidsnark_tpu_torch/tools/__init__.py
# (HBM_BYTES_PER_S, IMAD_PER_S, MONT_IMADS, scan_add_imads, bound_ms) at
# commit 6caa3f5, for the benchmark's rooflines.
"""The H100 SXM's peaks behind every roofline share, and the operation
counts of the MSM scan's mixed add."""

from __future__ import annotations

# HBM bytes a second, and 32-bit multiply-adds a second (132 SMs x 64 a
# clock, CUDA's throughput table for compute capability 9.0, x the 1.98 GHz
# boost clock); a Montgomery product of 8 x 8 32-bit limbs counts as 264
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
MONT_IMADS = 264


def scan_add_imads(curve: str) -> int:
    """Multiply-adds of one mixed add of the MSM's prefix scan on "g1"
    (14 Montgomery products, the relaxed law) or "g2" (33, the
    iso-twist's law, an Fq2 product counted as three)."""
    return {"g1": 14, "g2": 33}[curve] * MONT_IMADS


def bound_ms(nbytes, imads):
    """(ms, "bytes" or "operations"): the least time the card could take
    for work that moves nbytes and runs imads multiply-adds."""
    tb = nbytes / HBM_BYTES_PER_S
    to = imads / IMAD_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")
