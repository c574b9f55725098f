"""The MSM with points and scalars sharded along n over the ranks.

Counterpart of `rapidsnark_tpu/parallel/pmsm.py`: every rank runs the
local MSM (ops/msm.msm) on its n/D slice to per-window totals; the D
partial totals of each window are gathered (Mesh.all_gather, a few KB)
and summed by a running-sum pass of the `add` kernel (window totals are
plain group sums, so they add across ranks). The result is the same on
every rank.

The `add` kernel serves G1 (relaxed) and the G2 iso-twist only, and
msm maps G2 totals back onto the zkey's twist before it returns; so the
cross-rank sum of G2 totals runs on the iso-twist: the totals are mapped
onto it (fq_scale), summed, and mapped back, as ops/msm._combine_windows
does for the Horner ladder. Relaxed G1 totals lie in [0, 2p) and add as
they are.
"""

from __future__ import annotations

from ..ops import fused, msm as MSM
from .multihost import Mesh


def pad_len_sharded(n: int, n_devices: int, segment: int = 0) -> int:
    """The padded point count of an MSM sharded over n_devices ranks:
    every rank's slice a whole number of scan chunks and, with `segment`
    (a multiple of the chunk that slices a rank's GLV axis), a whole
    number of segments, so no slice straddles the rank's k1 / k2 halves.
    Padding points are (0, 0) with zero scalars."""
    unit = MSM._CHUNK * n_devices
    base = max(unit, -(-n // unit) * unit)
    if segment and segment % MSM._CHUNK == 0 and \
            segment < 2 * (base // n_devices):
        unit = segment * n_devices
        base = max(unit, -(-n // unit) * unit)
    return base


def msm_sharded(curve, local_pts, local_scalars, c: int, mesh: Mesh,
                window_group: int = 5, combine: bool = True,
                segment: int = 0):
    """MSM of this rank's slice (packed affine points (*b, n/D, A, 8),
    scalars (*b, n/D, 8); on G2 the points already on the iso-twist, as
    ops/msm.msm takes them) summed over the ranks.

    Returns, on every rank, the per-window totals (W, *b, L, 8) on
    `curve` with combine=False, or with combine=True one point per batch
    row (*b, L, 8) (the device Horner combine)."""
    part = MSM.msm(curve, local_pts, local_scalars, c, window_group,
                   combine=False, segment=segment)        # (W, *b, L, 8)
    sc = getattr(curve, "iso_scan", None) or curve
    if sc is not curve:
        part = MSM._iso_scale(curve, part, back=False)
    lanes = mesh.all_gather(part).movedim(0, -3)          # (W, *b, D, L, 8)
    total = fused.hillis_prefix(sc, lanes.contiguous(), mesh.size)
    wpts = total[..., -1, :, :].contiguous()
    if combine:
        wpts = MSM._horner(sc, wpts, wpts.shape[0], c)
    if sc is not curve:
        wpts = MSM._iso_scale(curve, wpts, back=True)
    return wpts
