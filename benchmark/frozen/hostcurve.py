# Frozen copy of rapidsnark_tpu_torch/utils/hostcurve.py at commit 6caa3f5 for the benchmark's yardstick.
# Changed: imports only.
"""Host-side projective EC arithmetic over Python ints (BN254 G1/G2).

The prover's tail — combining per-window MSM totals (~W*c doublings)
and the randomized proof assembly (groth16.cpp:209-246) — runs on the
host on a handful of points. The affine oracle (ref/curve.py) pays one
modular inversion per group op (~1500 inversions per proof, measured
0.2s+ of host time); these homogeneous-projective ops are inversion-free
(Renes-Costello-Batina complete formulas, eprint 2015/1060, a = 0 —
the same formulas as the device kernels in ops/curve.py), with a single
inversion per final output coordinate.

Points are (X, Y, Z) tuples; infinity is (0, 1, 0). The field is
abstract: ints mod p for G1, (c0, c1) pairs for G2/Fq2.
"""

from __future__ import annotations

from . import ref_field as F


class ProjGroup:
    def __init__(self, fadd, fsub, fmul, fscalar, finv, fzero, fone, b3):
        self.fadd, self.fsub, self.fmul = fadd, fsub, fmul
        self.fscalar, self.finv = fscalar, finv
        self.fzero, self.fone, self.b3 = fzero, fone, b3

    # -- representation -----------------------------------------------------
    def inf(self):
        return (self.fzero, self.fone, self.fzero)

    def from_affine(self, pt):
        """Affine (x, y) or None -> projective."""
        if pt is None:
            return self.inf()
        return (pt[0], pt[1], self.fone)

    def to_affine(self, p):
        """Projective -> affine (x, y) or None. One field inversion."""
        x, y, z = p
        if z == self.fzero:
            return None
        zi = self.finv(z)
        return (self.fmul(x, zi), self.fmul(y, zi))

    # -- group law (RCB Algorithm 7, a = 0; complete) -----------------------
    def add(self, p, q):
        fa, fs, fm = self.fadd, self.fsub, self.fmul
        x1, y1, z1 = p
        x2, y2, z2 = q
        t0 = fm(x1, x2)
        t1 = fm(y1, y2)
        t2 = fm(z1, z2)
        t3 = fs(fs(fm(fa(x1, y1), fa(x2, y2)), t0), t1)
        t4 = fs(fs(fm(fa(y1, z1), fa(y2, z2)), t1), t2)
        t5 = fs(fs(fm(fa(x1, z1), fa(x2, z2)), t0), t2)
        t0_3 = self.fscalar(t0, 3)
        t2b = fm(self.b3, t2)
        y3b = fm(self.b3, t5)
        z3 = fa(t1, t2b)
        t1m = fs(t1, t2b)
        x3 = fs(fm(t3, t1m), fm(t4, y3b))
        y3 = fa(fm(y3b, t0_3), fm(t1m, z3))
        z3o = fa(fm(z3, t4), fm(t0_3, t3))
        return (x3, y3, z3o)

    def double(self, p):
        return self.add(p, p)

    def neg(self, p):
        return (p[0], self.fsub(self.fzero, p[1]), p[2])

    def mul(self, p, k: int):
        """[k]P, plain-integer double-and-add (k NOT reduced mod the
        group order — ffiasm mulByScalar byte semantics, SURVEY.md §3.1)."""
        if k < 0:
            return self.neg(self.mul(p, -k))
        acc, cur = self.inf(), p
        while k:
            if k & 1:
                acc = self.add(acc, cur)
            cur = self.double(cur)
            k >>= 1
        return acc

    def combine_windows(self, window_points, c: int):
        """Horner combine of per-window MSM totals: sum_w 2^(wc) W_w."""
        acc = self.inf()
        for wp in reversed(window_points):
            for _ in range(c):
                acc = self.double(acc)
            acc = self.add(acc, wp)
        return acc


def _fq_add(a, b):
    return (a + b) % F.P


def _fq_sub(a, b):
    return (a - b) % F.P


def _fq_mul(a, b):
    return a * b % F.P


def _fq_scalar(a, k):
    return a * k % F.P


def _fq_inv(a):
    return pow(a, -1, F.P)


G1H = ProjGroup(_fq_add, _fq_sub, _fq_mul, _fq_scalar, _fq_inv, 0, 1, 9)
G2H = ProjGroup(F.fq2_add, F.fq2_sub, F.fq2_mul, F.fq2_scalar, F.fq2_inv,
                (0, 0), (1, 0), F.fq2_scalar(F.FQ2_B, 3))
