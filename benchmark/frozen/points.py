# Frozen copy of rapidsnark_tpu_torch/utils/points.py at commit 6caa3f5 for the benchmark's yardstick.
# Changed: imports only.
"""Host-side point conversions between device limb arrays and ref ints.

Device points are Jacobian, Montgomery-domain coordinates, limb arrays of
shape (..., 16) uint32 per coordinate (Fq2 coordinates: a pair of such).
Host points are the pure-Python ref representation: affine plain-int
tuples, None for infinity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .ref_field import FQ_CTX, P
from .limbs import int_to_limbs, limbs_to_int


def g1_affine_to_mont_limbs(pt: Optional[Tuple[int, int]]) -> np.ndarray:
    """ref G1 point -> (2, 16) Montgomery affine limbs ((0,0) = infinity)."""
    if pt is None:
        return np.zeros((2, 16), dtype=np.uint32)
    return np.stack([int_to_limbs(FQ_CTX.to_mont(pt[0])),
                     int_to_limbs(FQ_CTX.to_mont(pt[1]))])


def g2_affine_to_mont_limbs(pt) -> np.ndarray:
    """ref G2 point -> (4, 16) limbs, order x.c0 x.c1 y.c0 y.c1."""
    if pt is None:
        return np.zeros((4, 16), dtype=np.uint32)
    (x0, x1), (y0, y1) = pt
    return np.stack([int_to_limbs(FQ_CTX.to_mont(v)) for v in (x0, x1, y0, y1)])


def _coord(limbs) -> int:
    return FQ_CTX.from_mont(limbs_to_int(np.asarray(limbs)))


def proj_g1_int(x, y, z):
    """Device projective (Montgomery limbs) -> plain-int projective
    (X, Y, Z) for utils/hostcurve (no inversion)."""
    return (_coord(x), _coord(y), _coord(z))


def proj_g2_int(x, y, z):
    """Fq2 projective limbs ((c0,c1) pairs) -> plain-int-pair projective."""
    cc = lambda e: (_coord(e[0]), _coord(e[1]))  # noqa: E731
    return (cc(x), cc(y), cc(z))


def jac_to_affine_g1(x, y, z) -> Optional[Tuple[int, int]]:
    """Device Jacobian (Montgomery limbs) -> ref affine point."""
    zi = _coord(z)
    if zi == 0:
        return None
    xi, yi = _coord(x), _coord(y)
    zinv = pow(zi, -1, P)
    z2 = zinv * zinv % P
    return (xi * z2 % P, yi * z2 % P * zinv % P)


def proj_to_affine_g1(x, y, z) -> Optional[Tuple[int, int]]:
    """Homogeneous projective (Montgomery limbs) -> ref affine point."""
    zi = _coord(z)
    if zi == 0:
        return None
    zinv = pow(zi, -1, P)
    return (_coord(x) * zinv % P, _coord(y) * zinv % P)


def proj_to_affine_g2(x, y, z):
    """Homogeneous projective G2 -> ref affine ((c0,c1) pairs)."""
    z0, z1 = _coord(z[0]), _coord(z[1])
    if z0 == 0 and z1 == 0:
        return None
    from .ref_field import fq2_inv, fq2_mul
    zinv = fq2_inv((z0, z1))
    xq = (_coord(x[0]), _coord(x[1]))
    yq = (_coord(y[0]), _coord(y[1]))
    return (fq2_mul(xq, zinv), fq2_mul(yq, zinv))


def jac_to_affine_g2(x, y, z):
    """Device G2 Jacobian ((c0,c1) Montgomery limb pairs) -> ref affine."""
    z0, z1 = _coord(z[0]), _coord(z[1])
    if z0 == 0 and z1 == 0:
        return None
    from .ref_field import fq2_inv, fq2_mul
    zq = (z0, z1)
    xq = (_coord(x[0]), _coord(x[1]))
    yq = (_coord(y[0]), _coord(y[1]))
    zinv = fq2_inv(zq)
    z2 = fq2_mul(zinv, zinv)
    return (fq2_mul(xq, z2), fq2_mul(yq, fq2_mul(z2, zinv)))
