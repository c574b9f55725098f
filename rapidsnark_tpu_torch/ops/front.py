"""The prover's front kernels, each beside its plain version.

Counterpart of the JAX package's front arithmetic, which ran on the TPU
as XLA programs on 16-bit limbs: `_acc` (`slot_acc`, the spilled
records' `segment_sum`, `reduce_wide`, cvec = a*b;
rapidsnark_tpu/prover.py:578-660) and `_h_poly` (:686-700). Field
elements are packed element-major int32 words (..., 8). For a tensor on
the CPU a wrapper runs the plain PyTorch version next to it; for a CUDA
tensor it launches the hand-written kernel (csrc/front.cu) on the current
stream and counts the launch, or raises. There is no fallback.

  fr_slot_acc   row r = sum of mont(witness[s], v) over the row's K slots
                and its spilled records (standard form, canonical)
  fr_pointwise  a*b (b may be a row broadcast over a), a - b, and
                h = from_mont(a*b - c)

Inputs are canonical. A sum of modular additions gives the unique
canonical residue, so the kernels' words are those of the plain
versions' deferred-carry columns and `reduce_wide`, and of the JAX
package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import device as D
from . import field as FF
from .field import FR

POINTWISE_OPS = {"mul": 0, "sub": 1, "h": 2}

# the spilled records of fr_slot_acc: (left_s (m,) int64 witness indices,
# left_val (m, 8) values, left_order (m,) int32 sorting them by row,
# left_off (rows + 1,) int32 each row's span of left_order)
Spill = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def spill_csr(rows: torch.Tensor, nrows: int):
    """Target row of each spilled record (int64, any order) -> (order,
    offsets): int32 `order` lists the records sorted by row (stable),
    int32 `offsets` (nrows + 1,) gives row r the span offsets[r] ..
    offsets[r+1] of it. Built on the device of `rows`."""
    if rows.numel() >= 1 << 31:
        raise ValueError("more than 2^31 spilled coefficient records")
    order = torch.argsort(rows, stable=True)
    off = torch.zeros(nrows + 1, dtype=torch.int64, device=rows.device)
    off[1:] = torch.cumsum(torch.bincount(rows, minlength=nrows), 0)
    return order.to(torch.int32), off.to(torch.int32)


# ------------------------------------------------------------ fr_slot_acc --

def fr_slot_acc_plain(witness, coef_s, coef_val, K: int,
                      spill: Optional[Spill] = None):
    rows = coef_s.shape[0] // K
    prod = FR.mul(FF.unpack(witness[coef_s]), FF.unpack(coef_val))
    acc = prod.reshape(16, rows, K).sum(dim=-1)
    if spill is not None:
        ls, lv, order, off = spill
        order = order.long()
        lprod = FR.mul(FF.unpack(witness[ls[order]]), FF.unpack(lv[order]))
        row = torch.repeat_interleave(
            torch.arange(rows, device=acc.device), (off[1:] - off[:-1]).long())
        acc.index_add_(1, row, lprod)
    # int64 columns of 16-bit limbs hold any sum below 2^34 canonical
    # terms a row; two more columns give reduce_wide the carries
    acc = torch.cat([acc, torch.zeros_like(acc[:2])], dim=0)
    return FF.pack(FR.reduce_wide(acc))


def fr_slot_acc(witness: torch.Tensor, coef_s: torch.Tensor,
                coef_val: torch.Tensor, K: int,
                spill: Optional[Spill] = None) -> torch.Tensor:
    """The coefficient accumulation: (rows, 8) canonical standard-form
    words, row r = sum of mont(witness[s], v) over the slots r*K ..
    r*K+K-1 of (coef_s, coef_val) and over the spilled records of row r.

    witness: (nVars, 8) int32 standard-form words; coef_s: (rows*K,)
    int64; coef_val: (rows*K, 8) Montgomery words, 0 in an empty slot;
    spill: see `Spill` (offsets from spill_csr), or None."""
    if K < 1 or coef_s.dim() != 1 or coef_s.shape[0] % K:
        raise ValueError(f"fr_slot_acc: {tuple(coef_s.shape)} slots are not "
                         f"rows of K = {K}")
    if coef_val.shape != (coef_s.shape[0], 8):
        raise ValueError(f"fr_slot_acc: coef_val {tuple(coef_val.shape)} "
                         f"does not match coef_s {tuple(coef_s.shape)}")
    rows = coef_s.shape[0] // K
    if spill is not None and tuple(spill[3].shape) != (rows + 1,):
        raise ValueError(f"fr_slot_acc: offsets {tuple(spill[3].shape)} "
                         f"for {rows} rows")
    if witness.device.type == "cpu":
        return fr_slot_acc_plain(witness, coef_s, coef_val, K, spill)
    D.require(witness, "fr_slot_acc.witness", tail=(8,))
    D.require(coef_s, "fr_slot_acc.coef_s", dtype=torch.int64)
    D.require(coef_val, "fr_slot_acc.coef_val", tail=(8,))
    ptrs = [None] * 4
    if spill is not None:
        ls, lv, order, off = spill
        D.require(ls, "fr_slot_acc.left_s", dtype=torch.int64)
        D.require(lv, "fr_slot_acc.left_val", tail=(8,))
        D.require(order, "fr_slot_acc.left_order")
        D.require(off, "fr_slot_acc.left_off")
        if lv.shape[0] != ls.shape[0] or order.shape != ls.shape:
            raise ValueError("fr_slot_acc: spilled tables differ in length")
        ptrs = [t.data_ptr() for t in spill]
    out = torch.empty((rows, 8), dtype=torch.int32, device=witness.device)
    rc = D.lib("front").rs_fr_slot_acc(
        witness.data_ptr(), coef_s.data_ptr(), coef_val.data_ptr(), K, *ptrs,
        out.data_ptr(), rows, D.stream(witness))
    D.check(rc, "fr_slot_acc")
    D.count("fr_slot_acc")
    return out


# ----------------------------------------------------------- fr_pointwise --

def fr_pointwise_plain(op: str, a, b, c=None):
    x = FF.unpack(a)
    y = FF.unpack(b).reshape((16,) + (1,) * (a.dim() - b.dim())
                             + tuple(b.shape[:-1]))
    if op == "mul":
        r = FR.mul(x, y)
    elif op == "sub":
        r = FR.sub(*torch.broadcast_tensors(x, y))
    else:
        r = FR.from_mont(FR.sub(FR.mul(x, y), FF.unpack(c)))
    return FF.pack(r)


def fr_pointwise(op: str, a: torch.Tensor, b: torch.Tensor,
                 c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise Fr on packed words: op "mul" a*b, "sub" a - b, "h"
    from_mont(a*b - c) (groth16.cpp:162).

    a, c: (*s, 8) canonical; b: (*t, 8) with t a trailing part of s (a
    row operand broadcast over a's leading axes; (8,) is one element).
    Returns (*s, 8)."""
    if op not in POINTWISE_OPS:
        raise ValueError(f"fr_pointwise: unknown op {op!r}")
    if (c is not None) != (op == "h"):
        raise ValueError(f"fr_pointwise: op {op!r} takes "
                         + ("c" if op == "h" else "no c"))
    if b.dim() < 1 or b.dim() > a.dim() or \
            tuple(b.shape) != tuple(a.shape[a.dim() - b.dim():]):
        raise ValueError(f"fr_pointwise: b {tuple(b.shape)} is not a "
                         f"trailing part of a {tuple(a.shape)}")
    if c is not None and c.shape != a.shape:
        raise ValueError(f"fr_pointwise: c {tuple(c.shape)} is not a's "
                         f"{tuple(a.shape)}")
    if a.device.type == "cpu":
        return fr_pointwise_plain(op, a, b, c)
    for t, nm in ((a, "a"), (b, "b"), (c, "c")):
        if t is not None:
            D.require(t, f"fr_pointwise.{nm}", tail=(8,))
    out = torch.empty_like(a)
    rc = D.lib("front").rs_fr_pointwise(
        POINTWISE_OPS[op], a.data_ptr(), b.data_ptr(),
        None if c is None else c.data_ptr(), out.data_ptr(), a.numel() // 8,
        b.numel() // 8, D.stream(a))
    D.check(rc, "fr_pointwise")
    D.count("fr_pointwise")
    return out
