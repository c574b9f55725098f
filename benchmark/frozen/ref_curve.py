# Frozen copy of rapidsnark_tpu_torch/ref/curve.py at commit 6caa3f5 for the benchmark's yardstick.
# Changed: imports only.
"""BN254 G1/G2 group operations in pure Python (affine, test oracle).

Mirrors the capabilities the reference gets from ffiasm's curve.cpp /
alt_bn128.cpp (SURVEY.md §2.12): point add/double/negate, scalar mul,
naive multi-scalar mul, on-curve checks. Affine coordinates with modular
inverses — slow and simple, this is the oracle, not the compute path.

Points are `None` for the identity, else `(x, y)` with coordinates in the
relevant field (ints for G1, (c0, c1) pairs for G2).
"""

from __future__ import annotations

from . import ref_field as F
from .ref_field import P


class ECGroup:
    """Short-Weierstrass group y^2 = x^3 + b over an abstract field."""

    def __init__(self, add, sub, mul, inv, neg, eq, zero, one, b, scalar):
        self.fadd, self.fsub, self.fmul = add, sub, mul
        self.finv, self.fneg, self.feq = inv, neg, eq
        self.fzero, self.fone, self.b = zero, one, b
        self.fscalar = scalar  # multiply field element by small int

    # -- predicates ---------------------------------------------------------
    def is_zero(self, pt) -> bool:
        return pt is None

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        lhs = self.fmul(y, y)
        rhs = self.fadd(self.fmul(self.fmul(x, x), x), self.b)
        return self.feq(lhs, rhs)

    def eq(self, a, b) -> bool:
        if a is None or b is None:
            return a is None and b is None
        return self.feq(a[0], b[0]) and self.feq(a[1], b[1])

    # -- group law ----------------------------------------------------------
    def neg(self, pt):
        if pt is None:
            return None
        return (pt[0], self.fneg(pt[1]))

    def double(self, pt):
        if pt is None:
            return None
        x, y = pt
        if self.feq(y, self.fzero):
            return None
        # m = 3x^2 / 2y
        m = self.fmul(
            self.fscalar(self.fmul(x, x), 3),
            self.finv(self.fscalar(y, 2)),
        )
        nx = self.fsub(self.fmul(m, m), self.fscalar(x, 2))
        ny = self.fsub(self.fmul(m, self.fsub(x, nx)), y)
        return (nx, ny)

    def add(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        x1, y1 = a
        x2, y2 = b
        if self.feq(x1, x2):
            if self.feq(y1, y2):
                return self.double(a)
            return None  # P + (-P)
        m = self.fmul(self.fsub(y2, y1), self.finv(self.fsub(x2, x1)))
        nx = self.fsub(self.fsub(self.fmul(m, m), x1), x2)
        ny = self.fsub(self.fmul(m, self.fsub(x1, nx)), y1)
        return (nx, ny)

    def mul(self, pt, k: int):
        """Scalar multiplication, plain little-endian double-and-add.

        The scalar is used as a plain integer, NOT reduced mod the group
        order — matching ffiasm's mulByScalar byte semantics used at
        rapidsnark src/groth16.cpp:223-245 (r, s are raw 31-byte
        integers).
        """
        if k < 0:
            return self.neg(self.mul(pt, -k))
        result = None
        addend = pt
        while k:
            if k & 1:
                result = self.add(result, addend)
            addend = self.double(addend)
            k >>= 1
        return result

    def msm(self, points, scalars):
        """Naive multi-scalar multiplication (oracle for Pippenger)."""
        acc = None
        for pt, s in zip(points, scalars):
            acc = self.add(acc, self.mul(pt, s))
        return acc


# ---------------------------------------------------------------------------
# Concrete groups
# ---------------------------------------------------------------------------

def _fq_add(a, b):
    return (a + b) % P


def _fq_sub(a, b):
    return (a - b) % P


def _fq_mul(a, b):
    return a * b % P


def _fq_inv(a):
    return pow(a, -1, P)


def _fq_neg(a):
    return (-a) % P


def _fq_eq(a, b):
    return a % P == b % P


def _fq_scalar(a, k):
    return a * k % P


G1 = ECGroup(_fq_add, _fq_sub, _fq_mul, _fq_inv, _fq_neg, _fq_eq, 0, 1, 3,
             _fq_scalar)

G2 = ECGroup(F.fq2_add, F.fq2_sub, F.fq2_mul, F.fq2_inv, F.fq2_neg, F.fq2_eq,
             F.FQ2_ZERO, F.FQ2_ONE, F.FQ2_B, F.fq2_scalar)

# G1 lifted into Fq12 (used by the pairing; curve y^2 = x^3 + 3 over Fq12)
G12 = ECGroup(
    lambda a, b: a + b,
    lambda a, b: a - b,
    lambda a, b: a * b,
    lambda a: a.inv(),
    lambda a: -a,
    lambda a, b: a == b,
    F.Fq12.zero(),
    F.Fq12.one(),
    F.Fq12.from_fq(3),
    lambda a, k: a * k,
)

G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)
