"""The port's curve, NTT and row-gather kernels, each beside its plain
version.

Counterpart of `rapidsnark_tpu/ops/fused.py` (Pallas kernels for the
TPU) and of the row gather of `tools/bench_dma_gather.py`. Each wrapper
takes packed element-major int32 tensors (field elements (..., 8),
points (..., L, 8); rows (n, R) for the gather). For a tensor on the CPU
it runs the plain PyTorch version next to it; for a CUDA tensor it
launches the hand-written CUDA kernel (csrc/curve.cu, csrc/ntt.cu,
csrc/gather.cu) on the current stream and counts the launch, or raises.
There is no fallback.

  add               complete add; G1 relaxed law, G2 on the iso-twist
  scan_cols_packed  K sequential signed mixed adds, every accumulator out
  prefix_totals     exclusive running sum of rows of projective points
  ntt_butterfly     one radix-2 layer over split (lo, hi) halves
  ntt_fused_pass    consecutive radix-2 layers of a transform in one pass
  ntt_tail          the layers on bits 0-6 of the per-stage NTT path
  add_mixed_packed  strict projective + packed affine add (G1, G2 twist)
  add_mixed         the same add, the affine operand as 16-bit limbs
  dma_gather        row gather out[i] = table[idx[i]] by asynchronous copies
"""

from __future__ import annotations

import torch

from .. import device as D
from . import field as FF
from .curve import (G1P, G2P, G2P_ISO, is_g2, pack_point, relaxed_for,
                    unpack_point)
from .field import FR


def _curve_id(curve) -> int:
    """Kernel variant of a curve: 0 = G1 relaxed, 1 = the G2 iso-twist."""
    if curve is G1P:
        return 0
    if curve is G2P_ISO:
        return 1
    raise ValueError("the CUDA adders serve G1 and the G2 iso-twist only")


def _coords(curve) -> int:
    return 6 if is_g2(curve) else 3


# ---------------------------------------------------------------- add -----

def add_plain(curve, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    fn = curve.add_rx if relaxed_for(curve) else curve.add
    return pack_point(fn(unpack_point(curve, p), unpack_point(curve, q)))


def add(curve, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete add of packed projective points p, q: (*b, L, 8) int32
    (L = 3 on G1, 6 on G2). G1 runs the relaxed [0, 2p] law."""
    if p.device.type == "cpu":
        return add_plain(curve, p, q)
    cid = _curve_id(curve)
    L = _coords(curve)
    for t, nm in ((p, "p"), (q, "q")):
        D.require(t, f"add.{nm}", tail=(L, 8))
    if p.shape != q.shape:
        raise ValueError(f"add: shapes differ {tuple(p.shape)} {tuple(q.shape)}")
    out = torch.empty_like(p)
    n = p.numel() // (L * 8)
    rc = D.lib("curve").rs_add(cid, p.data_ptr(), q.data_ptr(),
                               out.data_ptr(), n, D.stream(p))
    D.check(rc, "add")
    D.count("add")
    return out


# ------------------------------------------------------ scan_cols_packed --

def scan_cols_plain(curve, acc: torch.Tensor, cols: torch.Tensor,
                    sign: torch.Tensor) -> torch.Tensor:
    f = curve.f
    add_mixed = curve.add_mixed_rx if relaxed_for(curve) else curve.add_mixed
    a = unpack_point(curve, acc)
    packed = acc
    outs = []
    for k in range(cols.shape[0]):
        if not bool(cols[k].any()):
            # every lane adds (0,0) = infinity, which the mixed add
            # answers with the accumulator unchanged: skip the column's
            # arithmetic (most of a small circuit's padded table)
            outs.append(packed)
            continue
        x2, y2 = unpack_point(curve, cols[k])
        # table points are canonical: the plain negation keeps the affine
        # operand canonical for add_mixed_rx
        y2 = f.select(sign[k] != 0, f.neg(y2), y2)
        a = add_mixed(a, (x2, y2))
        packed = pack_point(a)
        outs.append(packed)
    return torch.stack(outs)


def scan_cols_packed(curve, acc: torch.Tensor, cols: torch.Tensor,
                     sign: torch.Tensor) -> torch.Tensor:
    """K sequential signed mixed adds: out[k] = acc + sum_{j<=k} +-cols[j].

    acc: (*b, L, 8) projective; cols: (K, *b, A, 8) CANONICAL packed
    affine ((0,0) = infinity; A = 2 on G1, 4 on G2); sign: (K, *b) int32,
    1 => the column enters negated. Returns (K, *b, L, 8), every
    intermediate accumulator."""
    if acc.device.type == "cpu":
        return scan_cols_plain(curve, acc, cols, sign)
    cid = _curve_id(curve)
    L = _coords(curve)
    A = L - L // 3
    D.require(acc, "scan.acc", tail=(L, 8))
    D.require(cols, "scan.cols", tail=(A, 8))
    D.require(sign, "scan.sign")
    K = cols.shape[0]
    bsh = tuple(acc.shape[:-2])
    if tuple(cols.shape[1:-2]) != bsh or tuple(sign.shape) != (K,) + bsh:
        raise ValueError("scan_cols_packed: batch shapes disagree")
    out = torch.empty((K,) + tuple(acc.shape), dtype=torch.int32,
                      device=acc.device)
    n = acc.numel() // (L * 8)
    rc = D.lib("curve").rs_scan_cols(cid, acc.data_ptr(), cols.data_ptr(),
                                     sign.data_ptr(), out.data_ptr(), n, K,
                                     D.stream(acc))
    D.check(rc, "scan_cols_packed")
    D.count("scan_cols_packed")
    return out


# ------------------------------------------------------------ prefix_totals --
PREFIX_FOLD = 8                  # csrc/curve.cu PFX_T: totals a lane folds
PREFIX_LANES = (128, 32)         # lanes a block, by _curve_id


def hillis_prefix(curve, pt: torch.Tensor, size: int) -> torch.Tensor:
    """Inclusive running group sum along the lane axis (-3) of packed
    projective points: log2(size) roll-and-add steps, each an `add`."""
    steps = (size - 1).bit_length() if size > 1 else 0
    lane = torch.arange(size, device=pt.device)
    pt = pt.contiguous()
    for i in range(steps):
        sh = 1 << i
        rolled = torch.roll(pt, sh, dims=-3)
        summed = add(curve, pt, rolled.contiguous())
        pt = torch.where((lane < sh)[:, None, None], pt, summed)
    return pt


def prefix_totals_plain(curve, tot: torch.Tensor) -> torch.Tensor:
    """A two-level Hillis-Steele prefix (size/bi blocks of bi, the inner
    prefix, the outer prefix of the block totals, one broadcast add;
    hillis_prefix alone below 65 totals or off powers of two), shifted
    one place with infinity in front."""
    size = tot.shape[-3]
    bsh, tail = tuple(tot.shape[:-3]), tuple(tot.shape[-2:])
    inf = pack_point(curve.inf(bsh + (size,), tot.device))
    first = (torch.arange(size, device=tot.device) == 0)[:, None, None]
    if size <= 64 or (size & (size - 1)):
        incl = hillis_prefix(curve, tot, size)
    else:
        bi = 1 << ((size.bit_length() + 1) // 2)
        bo = size // bi
        inner = hillis_prefix(curve, tot.reshape(bsh + (bo, bi) + tail), bi)
        outer = hillis_prefix(curve, inner[..., -1, :, :], bo)
        rolled = torch.roll(outer, 1, dims=-3)
        excl = torch.where(first[:bo], inf[..., :bo, :, :], rolled)
        incl = add(curve, inner, excl[..., None, :, :].expand(
            inner.shape).contiguous()).reshape(tot.shape)
    return torch.where(first, inf, torch.roll(incl, 1, dims=-3))


def prefix_totals(curve, tot: torch.Tensor) -> torch.Tensor:
    """Exclusive running group sum along the lane axis (-3) of packed
    projective points: tot (*b, nb, L, 8) contiguous, nb >= 1 (L = 3 on
    G1, relaxed; 6 on the G2 iso-twist). Returns a
    new (*b, nb, L, 8): out[..., k] = tot[..., 0] + ... + tot[..., k-1],
    infinity at k = 0. On the card two launches (csrc/curve.cu
    k_prefix_tiles, k_prefix_out) whose adds run in another order than
    the plain version's: the same points, other projective words."""
    if tot.dim() < 3 or tot.shape[-3] < 1:
        raise ValueError(f"prefix_totals: totals {tuple(tot.shape)} are "
                         "not (..., nb >= 1, L, 8)")
    if tot.device.type == "cpu":
        return prefix_totals_plain(curve, tot)
    cid = _curve_id(curve)
    L = _coords(curve)
    D.require(tot, "prefix_totals.tot", tail=(L, 8))
    nb = tot.shape[-3]
    rows = tot.numel() // (nb * L * 8)
    out = torch.empty_like(tot)
    if rows == 0:
        return out
    # the workspace: each lane's prefix in its tile and each tile's total
    lanes = PREFIX_LANES[cid]
    tiles = -(-nb // (lanes * PREFIX_FOLD))
    words = rows * tiles * (lanes + 1) * L * 8
    work = torch.empty(words, dtype=torch.int32, device=tot.device)
    rc = D.lib("curve").rs_prefix_totals(cid, tot.data_ptr(), out.data_ptr(),
                                         work.data_ptr(), words, rows, nb,
                                         D.stream(tot))
    D.check(rc, "prefix_totals")
    D.count("prefix_totals", 2)
    return out


# ----------------------------------------------------------- ntt_butterfly --

def _bf(lo, hi, tw, dif: bool):
    """Radix-2 butterfly on limb elements: DIF (lo + hi, tw (lo - hi));
    DIT m = tw hi, (lo + m, lo - m)."""
    if dif:
        return FR.add(lo, hi), FR.mul(tw, FR.sub(lo, hi))
    m = FR.mul(tw, hi)
    return FR.add(lo, m), FR.sub(lo, m)


def ntt_butterfly_plain(lo, hi, tw, dif: bool):
    a, b = _bf(FF.unpack(lo), FF.unpack(hi), FF.unpack(tw), dif)
    return FF.pack(a), FF.pack(b)


def ntt_butterfly(lo: torch.Tensor, hi: torch.Tensor, tw: torch.Tensor,
                  dif: bool):
    """One radix-2 layer over packed Fr halves lo, hi, tw: (*b, 8)."""
    if lo.device.type == "cpu":
        return ntt_butterfly_plain(lo, hi, tw, dif)
    for t, nm in ((lo, "lo"), (hi, "hi"), (tw, "tw")):
        D.require(t, f"ntt_butterfly.{nm}", tail=(8,))
        if t.shape != lo.shape:
            raise ValueError("ntt_butterfly: shapes differ")
    olo, ohi = torch.empty_like(lo), torch.empty_like(hi)
    rc = D.lib("ntt").rs_ntt_butterfly(
        lo.data_ptr(), hi.data_ptr(), tw.data_ptr(), olo.data_ptr(),
        ohi.data_ptr(), lo.numel() // 8, int(dif), D.stream(lo))
    D.check(rc, "ntt_butterfly")
    D.count("ntt_butterfly")
    return olo, ohi


# ---------------------------------------------------------- ntt_fused_pass --
TILE_BITS = 10  # csrc/ntt.cu: a pass carries at most 10 layers


def stage_twiddles(tw: torch.Tensor, n: int, bit: int) -> torch.Tensor:
    """(h, 8) twiddles of the layer with half size h = 2^bit of an
    n-point transform: tw[j * n / (2h)] for j < h."""
    h = 1 << bit
    return tw[::n // (2 * h)][:h]


def ntt_fused_pass_plain(x, tw, lo_bit: int, nbits: int, dif: bool,
                         pre_mul=None):
    bsz, n = x.shape[0], x.shape[1]
    v = FF.unpack(x)                                   # (16, B, n)
    if pre_mul is not None:
        v = FR.mul(v, FF.unpack(pre_mul)[:, None, :])
    bits = range(lo_bit, lo_bit + nbits)
    for bit in (reversed(bits) if dif else bits):
        h = 1 << bit
        u = v.reshape(16, bsz, n // (2 * h), 2, h)
        twl = FF.unpack(stage_twiddles(tw, n, bit))[:, None, None, :]
        a, b = _bf(u[:, :, :, 0], u[:, :, :, 1], twl, dif)
        v = torch.stack([a, b], dim=3).reshape(16, bsz, n)
    return FF.pack(v)


def ntt_fused_pass(x: torch.Tensor, tw: torch.Tensor, lo_bit: int,
                   nbits: int, dif: bool, pre_mul=None) -> torch.Tensor:
    """Layers on bits lo_bit .. lo_bit+nbits-1 (nbits <= 10) of a radix-2
    transform in one pass: descending bits for DIF, ascending for DIT.

    x: (B, n, 8) packed Fr; tw: (n/2, 8) twiddles w^0..w^(n/2-1) of the
    direction; pre_mul: optional (n, 8) factor multiplied into every
    element (index mod n) before the first layer — the coset shift."""
    if x.device.type == "cpu":
        return ntt_fused_pass_plain(x, tw, lo_bit, nbits, dif, pre_mul)
    n = x.shape[1]
    logn = n.bit_length() - 1
    if not (1 <= nbits <= TILE_BITS and 0 <= lo_bit
            and lo_bit + nbits <= logn and n == 1 << logn):
        raise ValueError(f"ntt_fused_pass: bits {lo_bit}+{nbits} of 2^{logn}")
    D.require(x, "ntt_fused_pass.x", tail=(n, 8))
    D.require(tw, "ntt_fused_pass.tw", tail=(n // 2, 8))
    if pre_mul is not None:
        D.require(pre_mul, "ntt_fused_pass.pre_mul", tail=(n, 8))
    out = torch.empty_like(x)
    rc = D.lib("ntt").rs_ntt_fused_pass(
        x.data_ptr(), out.data_ptr(), tw.data_ptr(),
        None if pre_mul is None else pre_mul.data_ptr(), x.shape[0], logn,
        lo_bit, nbits, int(dif), D.stream(x))
    D.check(rc, "ntt_fused_pass")
    D.count("ntt_fused_pass")
    return out


# ---------------------------------------------------------------- ntt_tail --
TAIL_BITS = 7  # csrc/ntt.cu: the layers with half size below 128


def ntt_tail_plain(x, tw, dif: bool):
    bsz, n = x.shape[0], x.shape[1]
    tile = 1 << TAIL_BITS
    v = FF.unpack(x).reshape(16, bsz, n // tile, tile)
    bits = range(TAIL_BITS)
    for bit in (reversed(bits) if dif else bits):
        h = 1 << bit
        u = v.reshape(16, bsz, n // tile, tile // (2 * h), 2, h)
        twl = FF.unpack(stage_twiddles(tw, n, bit))[:, None, None, None, :]
        a, b = _bf(u[..., 0, :], u[..., 1, :], twl, dif)
        v = torch.stack([a, b], dim=-2).reshape(16, bsz, n // tile, tile)
    return FF.pack(v.reshape(16, bsz, n))


def ntt_tail(x: torch.Tensor, tw: torch.Tensor, dif: bool) -> torch.Tensor:
    """The layers on bits 0-6 (half sizes 64..1 descending for DIF, 1..64
    ascending for DIT) of a radix-2 transform in one launch: every
    partner lies inside a contiguous 128-element tile.

    x: (B, n, 8) packed Fr, n >= 128; tw: (n/2, 8) twiddles of the
    direction (the kernel reads the 127 rows those layers use)."""
    n = x.shape[1]
    logn = n.bit_length() - 1
    if n != 1 << logn or logn < TAIL_BITS:
        raise ValueError(f"ntt_tail: n = {n} is not a power of two >= 128")
    if x.device.type == "cpu":
        return ntt_tail_plain(x, tw, dif)
    D.require(x, "ntt_tail.x", tail=(n, 8))
    D.require(tw, "ntt_tail.tw", tail=(n // 2, 8))
    out = torch.empty_like(x)
    rc = D.lib("ntt").rs_ntt_tail(x.data_ptr(), out.data_ptr(),
                                  tw.data_ptr(), x.shape[0], logn, int(dif),
                                  D.stream(x))
    D.check(rc, "ntt_tail")
    D.count("ntt_tail")
    return out


# ------------------------------------------- add_mixed_packed, add_mixed ----

def _mixed_curve_id(curve) -> int:
    """Kernel variant of the strict mixed add: 0 = G1, 1 = G2 on the
    zkey's twist."""
    if curve is G1P:
        return 0
    if curve is G2P:
        return 1
    raise ValueError("the strict mixed adders serve G1 and the G2 twist only")


def add_mixed_packed_plain(curve, p, q):
    return pack_point(curve.add_mixed(unpack_point(curve, p),
                                      unpack_point(curve, q)))


def unpack_limb_point(curve, q: torch.Tensor):
    """(*b, A, 16) int32, one 16-bit limb per word -> affine pair of limb
    elements."""
    els = [q[..., i, :].movedim(-1, 0).to(torch.int64)
           for i in range(q.shape[-2])]
    if is_g2(curve):
        els = [(els[i], els[i + 1]) for i in range(0, len(els), 2)]
    return tuple(els)


def add_mixed_plain(curve, p, q):
    return pack_point(curve.add_mixed(unpack_point(curve, p),
                                      unpack_limb_point(curve, q)))


def _launch_add_mixed(name: str, curve, p, q, limbs: int):
    cid = _mixed_curve_id(curve)
    L = _coords(curve)
    A = L - L // 3
    D.require(p, f"{name}.p", tail=(L, 8))
    D.require(q, f"{name}.q", tail=(A, limbs))
    if p.shape[:-2] != q.shape[:-2]:
        raise ValueError(f"{name}: batch shapes differ {tuple(p.shape)} "
                         f"{tuple(q.shape)}")
    out = torch.empty_like(p)
    n = p.numel() // (L * 8)
    rc = getattr(D.lib("curve"), "rs_" + name)(
        cid, p.data_ptr(), q.data_ptr(), out.data_ptr(), n, D.stream(p))
    D.check(rc, name)
    D.count(name)
    return out


def add_mixed_packed(curve, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Strict (canonical) complete add of a projective and an affine
    point, on G1 or on G2's original twist.

    p: (*b, L, 8) canonical projective; q: (*b, A, 8) canonical packed
    affine, (0,0) = infinity. Returns (*b, L, 8), canonical."""
    if p.device.type == "cpu":
        return add_mixed_packed_plain(curve, p, q)
    return _launch_add_mixed("add_mixed_packed", curve, p, q, 8)


def add_mixed(curve, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """add_mixed_packed with the affine operand in limb form: q is
    (*b, A, 16) int32, one 16-bit limb per word (the kernel packs limb
    pairs in registers)."""
    if p.device.type == "cpu":
        return add_mixed_plain(curve, p, q)
    return _launch_add_mixed("add_mixed", curve, p, q, 16)


# -------------------------------------------------------------- dma_gather --
GATHER_THREADS = 128          # csrc/gather.cu: threads a block
GATHER_MAX_SMEM = 232448      # bytes of shared memory a block may stage in


def dma_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, idx.long())


def dma_gather(table: torch.Tensor, idx: torch.Tensor, blk: int = 512,
               nsem: int = 16) -> torch.Tensor:
    """Row gather out[i, :] = table[idx[i], :].

    table: (n, R) int32 rows, R % 4 == 0 (rows of whole 16-byte pieces);
    idx: (m,) int32, m % blk == 0 and blk % nsem == 0. A block of the
    kernel takes `blk` output rows and each of its threads keeps `nsem`
    16-byte copies in flight. Returns (m, R) int32. Indices are not
    checked against n on the card; on the CPU they raise as indexing
    does."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"dma_gather: table {tuple(table.shape)} must be "
                         f"(n, R) and idx {tuple(idx.shape)} (m,)")
    if table.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"dma_gather: expected int32 table and idx, got "
                         f"{table.dtype} and {idx.dtype}")
    if table.device != idx.device:
        raise ValueError(f"dma_gather: table on {table.device}, idx on "
                         f"{idx.device}")
    n, R = table.shape
    m = idx.shape[0]
    if R % 4:
        raise ValueError(f"dma_gather: rows of {R} words are not whole "
                         f"16-byte pieces")
    if blk < 1 or nsem < 1 or m % blk or blk % nsem:
        raise ValueError(f"dma_gather: m = {m} must be a multiple of blk = "
                         f"{blk}, and blk of nsem = {nsem}")
    if nsem * GATHER_THREADS * 16 > GATHER_MAX_SMEM:
        raise ValueError(f"dma_gather: nsem = {nsem} copies a thread do not "
                         f"fit a block's shared memory")
    if table.device.type == "cpu":
        return dma_gather_plain(table, idx)
    D.require(table, "dma_gather.table")
    D.require(idx, "dma_gather.idx")
    if table.data_ptr() % 16:
        raise ValueError("dma_gather: table is not 16-byte aligned")
    out = torch.empty((m, R), dtype=torch.int32, device=table.device)
    rc = D.lib("gather").rs_dma_gather(table.data_ptr(), idx.data_ptr(),
                                       out.data_ptr(), n, m, R, blk, nsem,
                                       D.stream(table))
    D.check(rc, "dma_gather")
    D.count("dma_gather")
    return out
