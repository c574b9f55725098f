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
                and its spilled records (canonical); a call makes up to
                three launches, each counted (the slots, the spilled
                records' chunks, the rows of several chunks)
  fr_pointwise  a*b (b may be a row broadcast over a), a - b, and
                h = from_mont(a*b - c)

Inputs are canonical. A sum of modular additions gives the unique
canonical residue, so the kernels' words are those of the plain
versions' deferred-carry columns and `reduce_wide`, and of the JAX
package's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import device as D
from . import field as FF
from .field import FR

POINTWISE_OPS = {"mul": 0, "sub": 1, "h": 2}

SPILL_CHUNK = 1024      # spilled records a warp sums as one work item


class Spill(NamedTuple):
    """The coefficient records past their row's K slots, sorted by row
    (stable): int32 witness indices `s` (m,) and values `val` (m, 8),
    int32 CSR offsets `off` (rows + 1,) giving row r the records
    off[r] .. off[r+1], and spill_work's `items` and `multi`."""
    s: torch.Tensor
    val: torch.Tensor
    off: torch.Tensor
    items: torch.Tensor
    multi: torch.Tensor


# the Spill fields as Prover / convert table names
SPILL_TABLES = ("left_s", "left_val", "left_off", "left_items", "left_multi")


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


def spill_work(off: torch.Tensor, chunk: int = SPILL_CHUNK):
    """The kernel's work list for CSR offsets `off` (rows + 1,): `items`
    (n, 3) int32 (row, begin, end), each row's records cut into spans of
    `chunk` and a last shorter one, rows ascending and empty rows left
    out; `multi` (m, 3) int32 (row, first item, end item) for the rows
    of two or more items, whose partial sums a second launch adds."""
    off = off.long()
    nch = (off[1:] - off[:-1] + chunk - 1) // chunk
    first = torch.cumsum(nch, 0) - nch
    row = torch.repeat_interleave(
        torch.arange(nch.shape[0], device=off.device), nch)
    beg = off[row] + (torch.arange(row.shape[0], device=off.device)
                      - first[row]) * chunk
    end = torch.minimum(beg + chunk, off[row + 1])
    many = torch.nonzero(nch > 1).squeeze(1)
    items = torch.stack([row, beg, end], dim=1).to(torch.int32)
    multi = torch.stack([many, first[many], first[many] + nch[many]],
                        dim=1).to(torch.int32)
    return items.contiguous(), multi.contiguous()


def make_spill(s: torch.Tensor, val: torch.Tensor, rows: torch.Tensor,
               nrows: int, chunk: int = SPILL_CHUNK):
    """Spilled records (witness indices s, values val (m, 8), target rows
    rows, all on one device, any order) -> (Spill, order): the records
    sorted by row and their work list; int32 `order` (spill_csr's) maps
    a sorted position to the record's position in the input."""
    order, off = spill_csr(rows, nrows)
    items, multi = spill_work(off, chunk)
    o = order.long()
    return Spill(s[o].to(torch.int32).contiguous(), val[o].contiguous(), off,
                 items, multi), order


def slot_tables(s: torch.Tensor, val: torch.Tensor, rows: torch.Tensor,
                nrows: int, K: int):
    """Bin records (witness index s, int32 or int64; value val (m, 8);
    int64 target row rows; all on one device) into K slots a row, in
    their order within a row -> (coef_s (K, nrows) int32, coef_val (K,
    nrows, 8) slot-major, 0 in an empty slot; left (n,) int64 the records
    past K slots, ascending; their rank in the row minus K). Each
    full-width temporary is freed once used (at 2^26 records one int64
    array is 0.5 GB)."""
    m = rows.shape[0]
    dev = rows.device
    order = torch.argsort(rows, stable=True)
    cnt = torch.bincount(rows, minlength=nrows)
    start = torch.cumsum(cnt, 0) - cnt
    del cnt
    pos = torch.arange(m, device=dev)
    pos -= start[rows[order]]
    del start
    rank = torch.empty_like(rows)
    rank[order] = pos
    del order, pos
    main = rank < K
    rec = torch.nonzero(main).squeeze(1)
    dst = rank[rec] * nrows + rows[rec]
    coef_s = torch.zeros((K, nrows), dtype=torch.int32, device=dev)
    coef_val = torch.zeros((K, nrows, 8), dtype=val.dtype, device=dev)
    coef_s.view(-1)[dst] = s[rec].to(torch.int32)
    coef_val.view(-1, 8)[dst] = val[rec]
    del rec, dst
    left = torch.nonzero(~main).squeeze(1)
    return coef_s, coef_val, left, rank[left] - K


# ------------------------------------------------------------ fr_slot_acc --

def fr_slot_acc_plain(witness, coef_s, coef_val,
                      spill: Optional[Spill] = None):
    rows = coef_s.shape[1]
    prod = FR.mul(FF.unpack(witness[coef_s.long()]), FF.unpack(coef_val))
    acc = prod.sum(dim=1)                                  # (16, rows)
    if spill is not None:
        lprod = FR.mul(FF.unpack(witness[spill.s.long()]),
                       FF.unpack(spill.val))
        row = torch.repeat_interleave(
            torch.arange(rows, device=acc.device),
            (spill.off[1:] - spill.off[:-1]).long())
        acc.index_add_(1, row, lprod)
    # int64 columns of 16-bit limbs hold any sum below 2^34 canonical
    # terms a row; two more columns give reduce_wide the carries
    acc = torch.cat([acc, torch.zeros_like(acc[:2])], dim=0)
    return FF.pack(FR.reduce_wide(acc))


def fr_slot_acc(witness: torch.Tensor, coef_s: torch.Tensor,
                coef_val: torch.Tensor,
                spill: Optional[Spill] = None) -> torch.Tensor:
    """The coefficient accumulation: (rows, 8) canonical words, row r =
    sum of mont(witness[s], v) over the slots (k, r) of (coef_s,
    coef_val) and over the spilled records of row r. With the witness in
    standard form (the Prover's) that is the standard form of the sum of
    witness * coefficient; with a table of Montgomery words gathered
    (the fixture generator's Lagrange values) it is Montgomery form.

    witness: (nVars, 8) int32 words; coef_s: (K, rows) int32 indices
    (K may be 0); coef_val: (K, rows, 8) Montgomery words, 0 in an empty
    slot; spill: a Spill over the same rows (make_spill), or None."""
    if coef_s.dim() != 2 or coef_val.shape != tuple(coef_s.shape) + (8,):
        raise ValueError(f"fr_slot_acc: coef_s {tuple(coef_s.shape)} and "
                         f"coef_val {tuple(coef_val.shape)} are not (K, "
                         f"rows) and (K, rows, 8)")
    rows = coef_s.shape[1]
    if spill is not None and (
            tuple(spill.off.shape) != (rows + 1,)
            or spill.val.shape != tuple(spill.s.shape) + (8,)
            or spill.items.shape[1:] != (3,)
            or spill.multi.shape[1:] != (3,)):
        raise ValueError(f"fr_slot_acc: spill of {tuple(spill.s.shape)} "
                         f"records with offsets {tuple(spill.off.shape)} "
                         f"for {rows} rows")
    if witness.device.type == "cpu":
        return fr_slot_acc_plain(witness, coef_s, coef_val, spill)
    D.require(witness, "fr_slot_acc.witness", tail=(8,))
    D.require(coef_s, "fr_slot_acc.coef_s")
    D.require(coef_val, "fr_slot_acc.coef_val", tail=(8,))
    out = torch.empty((rows, 8), dtype=torch.int32, device=witness.device)
    sp, nitems, nmulti, part = [None] * 5, 0, 0, None
    if spill is not None:
        for t, nm in zip(spill, SPILL_TABLES):
            D.require(t, f"fr_slot_acc.{nm}")
        nitems, nmulti = spill.items.shape[0], spill.multi.shape[0]
        sp = [t.data_ptr() for t in spill]
        if nmulti:
            part = torch.empty((nitems, 8), dtype=torch.int32,
                               device=witness.device)
    K = coef_s.shape[0]
    rc = D.lib("front").rs_fr_slot_acc(
        witness.data_ptr(), coef_s.data_ptr(), coef_val.data_ptr(), K,
        sp[0], sp[1], sp[2], sp[3], nitems, sp[4], nmulti,
        None if part is None else part.data_ptr(), out.data_ptr(), rows,
        D.stream(witness))
    D.check(rc, "fr_slot_acc")
    D.count("fr_slot_acc", 1 + (nitems > 0) + (nmulti > 0))
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
