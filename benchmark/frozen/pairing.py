# Frozen copy of rapidsnark_tpu_torch/ref/pairing.py at commit 6caa3f5 for the benchmark's yardstick.
# Changed: imports only.
"""Optimal-ate pairing on BN254, pure Python (py_ecc-style construction).

This is the snarkjs-replacement verification oracle: the reference's only
integration test is "snarkjs verifies the proof" (SURVEY.md §4); in this
repo that role is played by `groth16_pairing_check` below.

Construction: G2 points are lifted to the curve y^2 = x^3 + 3 over Fq12
via the D-type twist (x, y) -> (x * w^2, y * w^3) with w^6 = 9 + i, and
the Miller loop runs with affine line functions in Fq12.
"""

from __future__ import annotations

from .ref_curve import G12, G1_GEN, G2_GEN
from .ref_field import Fq12, P, R_FR

# 6u + 2 for BN254 (u = 4965661367192848881)
ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE_LOOP_COUNT = 63

_W2 = Fq12((0,) * 2 + (1,) + (0,) * 9)  # w^2
_W3 = Fq12((0,) * 3 + (1,) + (0,) * 8)  # w^3


def twist(pt):
    """Lift a G2 point ((x0,x1),(x0,y1)) onto E(Fq12)."""
    if pt is None:
        return None
    x, y = pt
    return (Fq12.from_fq2(x) * _W2, Fq12.from_fq2(y) * _W3)


def cast_g1(pt):
    """Embed a G1 point into E(Fq12)."""
    if pt is None:
        return None
    return (Fq12.from_fq(pt[0]), Fq12.from_fq(pt[1]))


def _linefunc(p1, p2, t):
    """Line through p1, p2 evaluated at t (affine, all in Fq12)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    elif y1 == y2:
        m = (x1 * x1) * 3 / (y1 * 2)
        return m * (xt - x1) - (yt - y1)
    else:
        return xt - x1


def miller_loop(q, p) -> Fq12:
    """Miller loop (no final exponentiation). q, p are E(Fq12) points."""
    if q is None or p is None:
        return Fq12.one()
    r = q
    f = Fq12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f * f * _linefunc(r, r, p)
        r = G12.double(r)
        if ATE_LOOP_COUNT & (2 ** i):
            f = f * _linefunc(r, q, p)
            r = G12.add(r, q)
    # Frobenius endomorphism twists (coordinate-wise x -> x^P in Fq12)
    q1 = (q[0] ** P, q[1] ** P)
    nq2 = (q1[0] ** P, -(q1[1] ** P))
    f = f * _linefunc(r, q1, p)
    r = G12.add(r, q1)
    f = f * _linefunc(r, nq2, p)
    return f


def final_exponentiate(f: Fq12) -> Fq12:
    return f ** ((P ** 12 - 1) // R_FR)


def pairing(q_g2, p_g1) -> Fq12:
    """e(P, Q) with P in G1, Q in G2 (affine int / Fq2 tuples)."""
    return final_exponentiate(miller_loop(twist(q_g2), cast_g1(p_g1)))


def pairing_product_is_one(pairs) -> bool:
    """Check prod e(Pi, Qi) == 1 with a single final exponentiation.

    pairs: iterable of (g1_point, g2_point).
    """
    f = Fq12.one()
    for p_g1, q_g2 in pairs:
        f = f * miller_loop(twist(q_g2), cast_g1(p_g1))
    return final_exponentiate(f).is_one()
