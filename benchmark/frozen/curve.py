# Frozen copy of rapidsnark_tpu_torch/ops/curve.py at commit 6caa3f5 for the benchmark's input maker.
# Changed: imports; only the strict mixed add, and what it calls, kept.
"""Complete projective group law for G1 (Fq) and G2 (Fq2) on torch limbs.

The plain counterpart of `rapidsnark_tpu/ops/curve.py`: the
Renes-Costello-Batina formulas (eprint 2015/1060, Algorithm 8, a = 0),
branch-free and complete.
Points are (X, Y, Z) tuples of field elements ((16, *batch) int64
limbs; Fq2 elements are (c0, c1) pairs); infinity is (0, 1, 0). The
same formulas, op for op, run in the CUDA kernels (csrc/curve.cu), so
the kernels' outputs are word-identical to these.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import field as FF
from .field import FieldOps, FQ


class Fq2Ops:
    """Fq2 = Fq[i]/(i^2+1) with the FieldOps interface; elements are
    (c0, c1) tuples. Linear ops stack both components into one base op."""

    def __init__(self, base: FieldOps):
        self.f = base

    @staticmethod
    def _stack2(a):
        return torch.stack([a[0], a[1]], dim=1)

    @staticmethod
    def _unstack2(v):
        return (v[:, 0], v[:, 1])

    def zero(self, shape=(), device="cpu"):
        return (self.f.zero(shape, device), self.f.zero(shape, device))

    def one_mont(self, shape=(), device="cpu"):
        return (self.f.one_mont(shape, device), self.f.zero(shape, device))

    def const(self, pair, shape=(), device="cpu"):
        """Fq2 constant from a pair of stored-form (Montgomery) ints."""
        return (self.f.const(pair[0], shape, device),
                self.f.const(pair[1], shape, device))

    def add(self, a, b):
        return self._unstack2(self.f.add(self._stack2(a), self._stack2(b)))

    def sub(self, a, b):
        return self._unstack2(self.f.sub(self._stack2(a), self._stack2(b)))

    def add_lazy(self, a, b):
        """The canonical add: Fq2-level lazy operands would push the
        Karatsuba interior sums past the base mul's < 2p input bound."""
        return self.add(a, b)

    def double(self, a):
        s = self._stack2(a)
        return self._unstack2(self.f.add(s, s))

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def mul_many(self, pairs):
        """k Fq2 products as one base mul over 3k operands (Karatsuba:
        re = a0b0 - a1b1, im = (a0+a1)(b0+b1) - a0b0 - a1b1)."""
        f = self.f
        k = len(pairs)
        bc = [tuple(torch.broadcast_tensors(*(list(p[0]) + list(p[1]))))
              for p in pairs]
        asum = f.add_lazy(torch.stack([t[0] for t in bc], dim=1),
                          torch.stack([t[1] for t in bc], dim=1))
        bsum = f.add_lazy(torch.stack([t[2] for t in bc], dim=1),
                          torch.stack([t[3] for t in bc], dim=1))
        base_pairs = []
        for i, t in enumerate(bc):
            base_pairs.append((t[0], t[2]))
            base_pairs.append((t[1], t[3]))
            base_pairs.append((asum[:, i], bsum[:, i]))
        outs = f.mul_many(base_pairs)
        m0 = torch.stack([outs[3 * i] for i in range(k)], dim=1)
        m1 = torch.stack([outs[3 * i + 1] for i in range(k)], dim=1)
        t = torch.stack([outs[3 * i + 2] for i in range(k)], dim=1)
        first = f.sub(torch.cat([m0, t], dim=1), torch.cat([m1, m0], dim=1))
        re, tm0 = first[:, :k], first[:, k:]
        im = f.sub(tm0, m1)
        return [(re[:, i], im[:, i]) for i in range(k)]

    def select(self, mask, a, b):
        return (self.f.select(mask, a[0], b[0]),
                self.f.select(mask, a[1], b[1]))

    def is_zero(self, a):
        return self.f.is_zero(a[0]) & self.f.is_zero(a[1])


FQ2 = Fq2Ops(FQ)

Point = Tuple


def _leaf(e):
    while isinstance(e, tuple):
        e = e[0]
    return e


def _shape_of(elem):
    """Batch shape of a field element ((16, *batch) tensor or Fq2 pair)."""
    return tuple(_leaf(elem).shape[1:])


def _tree_stack_leaves(elems):
    if isinstance(elems[0], tuple):
        return tuple(_tree_stack_leaves([e[k] for e in elems])
                     for k in range(len(elems[0])))
    return torch.stack(torch.broadcast_tensors(*elems), dim=1)


def _tree_unstack_leaves(stacked, k):
    def ix(e, i):
        if isinstance(e, tuple):
            return tuple(ix(c, i) for c in e)
        return e[:, i]
    return [ix(stacked, i) for i in range(k)]


class ProjCurveOps:
    """RCB complete group law in homogeneous projective coordinates.

    `b3_mont`: 3b in Montgomery plain-int form, or None for the G1
    shortcut b3 = 9 (three doublings + add)."""

    def __init__(self, f, b3_mont=None):
        self.f = f
        self.b3_mont = b3_mont

    # -- representation -------------------------------------------------------
    def select(self, mask, a: Point, b: Point) -> Point:
        return tuple(self.f.select(mask, x, y) for x, y in zip(a, b))

    def inf(self, shape=(), device="cpu") -> Point:
        return (self.f.zero(shape, device), self.f.one_mont(shape, device),
                self.f.zero(shape, device))

    def _mul_b3(self, ts):
        """[b3 * t for t in ts] as one batched op."""
        f = self.f
        if self.b3_mont is None:                            # b3 = 9
            stacked = _tree_stack_leaves(ts)
            t8 = f.double(f.double(f.double(stacked)))
            out = f.add(t8, stacked)
            return _tree_unstack_leaves(out, len(ts))
        c = f.const(self.b3_mont, _shape_of(ts[0]), _leaf(ts[0]).device)
        return f.mul_many([(t, c) for t in ts])

    # -- mixed add (RCB Algorithm 8, a = 0, Z2 = 1) -----------------------------
    def add_mixed(self, p: Point, q) -> Point:
        """P + (x2, y2), (0,0) encoding the affine point at infinity."""
        f = self.f
        x1, y1, z1 = p
        x2, y2 = q
        la = f.add_lazy
        t0, t1, s3, t4a, y3a = f.mul_many([
            (x1, x2), (y1, y2),
            (la(x1, y1), la(x2, y2)),
            (y2, z1), (x2, z1),
        ])
        t3 = f.sub(f.sub(s3, t0), t1)
        t4 = f.add(t4a, y1)
        y3l = f.add(y3a, x1)
        t0_3 = f.add(f.double(t0), t0)
        t2b, y3b = self._mul_b3([z1, y3l])
        z3 = f.add(t1, t2b)
        t1m = f.sub(t1, t2b)
        m1, m2, m3, m4, m5, m6 = f.mul_many([
            (t4, y3b), (t3, t1m), (y3b, t0_3),
            (t1m, z3), (t0_3, t3), (z3, t4),
        ])
        out = (f.sub(m2, m1), f.add(m4, m3), f.add(m6, m5))
        q_inf = f.is_zero(x2) & f.is_zero(y2)
        return self.select(q_inf, p, out)


def _leaves(pt):
    out = []
    for c in pt:
        out.extend(c if isinstance(c, tuple) else (c,))
    return out


def pack_point(pt) -> torch.Tensor:
    """Point (or affine pair) of limb elements -> packed (*b, L, 8) int32,
    coordinates in order x, y[, z] (Fq2: c0 before c1)."""
    return torch.stack([FF.pack(e) for e in _leaves(pt)], dim=-2)


def unpack_point(curve, t: torch.Tensor):
    """Packed (*b, L, 8) int32 -> point tuple of limb elements."""
    els = [FF.unpack(t[..., i, :]) for i in range(t.shape[-2])]
    if is_g2(curve):
        els = [(els[i], els[i + 1]) for i in range(0, len(els), 2)]
    return tuple(els)


def is_g2(curve) -> bool:
    return isinstance(curve.f, Fq2Ops)


# RCB instances. G1: b3 = 9. G2 twist: b3 = 9/(9+i), Montgomery-encoded.
from . import ref_field as _rf  # noqa: E402

_B3_G2 = _rf.fq2_scalar(_rf.FQ2_B, 3)
G1P = ProjCurveOps(FQ)
G2P = ProjCurveOps(
    FQ2, b3_mont=(_B3_G2[0] * (1 << 256) % _rf.P,
                  _B3_G2[1] * (1 << 256) % _rf.P))

