"""Pippenger multi-scalar multiplication by sort + prefix scan (torch).

Counterpart of `rapidsnark_tpu/ops/msm.py`. Per c-bit window: signed
digit recode, one stable sort by digit, a gather of the sorted points,
the all-positions prefix sums of the sorted points
(ops/fused.scan_cols_packed over C = 256 columns, then the exclusive
prefix of the chunk totals, ops/fused.prefix_totals), and the telescoped
window total sum_j j*B_j = sum_{j<M} (A_M - A_j) with A_j the prefix sum at the
bucket-j boundary (one boundary gather-add, one wide difference, one
halving tree). Windows ride a batch axis in groups of G; scalars split
by GLV into 128-bit halves over the virtual table [P, phi(P)]; the G2
scan runs on the cheap-b3 iso-twist and the window totals are mapped
back. With `segment` the point axis is cut into slices: each slice
yields one point per window, summed across slices with ops/fused.add,
so the scan's working set is a slice's, not the table's.

Points are packed element-major int32 tensors: affine tables
(*batch, n, A, 8) with A = 2 (G1) / 4 (G2) and (0,0) = infinity, the
zkey's own point layout; projective points (..., L, 8), L = 3 / 6.
Scalars are (*batch, n, 8) packed words of plain little-endian integers.

The scalars' preparation (GLV split and signed-digit recode), the
points' (phi image, negation, the iso-twist's scaling) and the bucket
ordering run on hand-written kernels, each beside its plain version:

  glv_digits   GLV halves of the scalars and their encoded signed digits
               (csrc/msm.cu)
  fq_scale     packed Fq / Fq2 coordinates times a constant, or negated
               (csrc/msm.cu)
  digit_sort   the stable sort of a window group's digits, its
               permutation, the sign columns and the bucket boundaries
               (csrc/sort.cu)
  gather_cols  the sorted points in the scan's column layout
               (csrc/gather.cu)

For a tensor on the CPU a wrapper runs the plain PyTorch version; for a
CUDA tensor it launches the kernel on the current stream and counts the
launch, or raises. There is no fallback.

Five spans (utils/logger.phase, named without a sink) cover a prove's
MSM work: msms.prep (the digits and the slice's phi image), msms.sort,
msms.gather, msms.scan (the chunk scans and their totals' prefix) and
msms.buckets (the boundary lookups, the telescoped difference, the
halving tree and the add into the running totals). While spans are on
they add into the calling Prover's last_phases; called with no Prover
they only mark the profiler's trace. While spans are on, each window
group also counts into last_phases the (point, window) entries it sorts
and scans (`count.msms.entries`, from the shapes) and those whose digit
is nonzero (`count.msms.live`, from the sort's bucket boundaries on the
card, read with the spans' events).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from .. import device as D
from ..ref.field import P as _P
from ..utils.logger import count, counting, phase
from . import field as FF
from . import fused
from . import glv as GLV
from .curve import FQ2, G2P_ISO, is_g2, pack_point, relaxed_for
from .field import FQ

SCALAR_BITS = 256
_CHUNK = 256  # columns of the sequential chunk scan (one kernel launch)
_ROW_GATHER_BLK = 256  # dma_gather's rows a block in _ps_at's lookups


# ---------------------------------------------------------------------------
# packed point helpers
# ---------------------------------------------------------------------------

def point_inf(curve, shape, device) -> torch.Tensor:
    return pack_point(curve.inf(tuple(shape), device))


def _select(mask, a, b):
    """mask ? a : b over packed points; mask is batch-shaped."""
    return torch.where(mask[..., None, None], a, b)


def point_neg(curve, pt: torch.Tensor) -> torch.Tensor:
    """-P on packed projective points (..., L, 8) (relaxed negation on
    G1: y -> 2p - y), through fq_scale."""
    op = "neg_rx" if relaxed_for(curve) else "neg"
    return fq_scale(pt, (None, op, None), 2 if is_g2(curve) else 1)


def _batch_index(shape, nbatch: int, device):
    """Broadcastable aranges for the first `nbatch` axes of `shape`."""
    out = []
    for d in range(nbatch):
        view = [1] * len(shape)
        view[d] = shape[d]
        out.append(torch.arange(shape[d], device=device).view(view))
    return out


# ---------------------------------------------------------------------------
# prefix machinery
# ---------------------------------------------------------------------------

def _chunked_prefix(curve, cols, sign, batch: Tuple[int, ...], nb: int):
    """All-positions inclusive prefix sums of sorted affine points.

    cols: (C, *batch, nb, A, 8) — column c of chunk b holds sorted entry
    b*C + c; sign: (C, *batch, nb) int32. Returns (within, excl):
    within (C, *batch, nb, L, 8) the in-chunk inclusive prefixes and
    excl (*batch, nb, L, 8) the exclusive chunk offsets, so
    PS(k) = excl[k // C] + within[k % C] for the first k+1 entries."""
    acc0 = point_inf(curve, batch + (nb,), cols.device)
    within = fused.scan_cols_packed(curve, acc0, cols, sign)
    return within, fused.prefix_totals(curve, within[-1])


def _row_gather(table, idx):
    """table (rows, R) int32 rows by idx (m,) int32 through
    ops/fused.dma_gather, the index padded to whole blocks of the kernel
    with row 0: (m, R)."""
    m = idx.shape[0]
    pad = -m % _ROW_GATHER_BLK
    if pad:
        idx = torch.cat([idx, idx.new_zeros(pad)])
    return fused.dma_gather(table, idx, blk=_ROW_GATHER_BLK)[:m]


def _ps_at(curve, within, excl, k):
    """PS(k) = sum of the first k sorted points; k: (*batch, m) integer
    counts (digit_sort's boundaries). The two lookups are row gathers
    (dma_gather) of within's (C, *batch, nb) and excl's (*batch, nb)
    points."""
    bshape, m = tuple(k.shape[:-1]), k.shape[-1]
    L = within.shape[-2]
    nb = excl.shape[-3]
    nrows = excl.numel() // (nb * L * 8)
    pos = torch.clamp(k.to(torch.int32).reshape(nrows, m) - 1, min=0)
    erow = torch.arange(nrows, dtype=torch.int32, device=k.device)[:, None] \
        * nb + pos // _CHUNK
    wrow = (pos % _CHUNK) * (nrows * nb) + erow
    w = _row_gather(within.reshape(-1, L * 8), wrow.reshape(-1))
    e = _row_gather(excl.reshape(-1, L * 8), erow.reshape(-1))
    shape = bshape + (m, L, 8)
    s = fused.add(curve, w.view(shape), e.view(shape))
    return _select(k == 0, point_inf(curve, tuple(k.shape), k.device), s)


def _tree_total(curve, pt, size: int):
    """Group sum along the lane axis: a pairwise halving tree down to 64
    lanes, then one Hillis pass."""
    if size > 64 and not (size & (size - 1)):
        while size > 64:
            half = size // 2
            pt = fused.add(curve, pt[..., :half, :, :].contiguous(),
                           pt[..., half:, :, :].contiguous())
            size = half
    res = fused.hillis_prefix(curve, pt, size)
    return res[..., -1, :, :]


# ---------------------------------------------------------------------------
# digit extraction
# ---------------------------------------------------------------------------

def _u32(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.int64) & 0xFFFFFFFF


def window_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(*batch, n, 8) packed scalars -> (W, *batch, n) c-bit digits."""
    assert 1 <= c <= 16
    nwin = -(-SCALAR_BITS // c)
    s = _u32(scalars)
    s = torch.cat([s, torch.zeros_like(s[..., :1])], dim=-1)
    rows = []
    for w in range(nwin):
        word, off = divmod(w * c, 32)
        v = s[..., word] >> off
        if off:
            v = v | (s[..., word + 1] << (32 - off))
        rows.append(v & ((1 << c) - 1))
    return torch.stack(rows)


def _raw_digit(scalars, w: int, c: int, lead: bool = False):
    """Window w's unsigned c-bit digit; word axis trailing, or leading
    with lead=True (the GLV layout). Words are u32 values in int64."""
    nw = scalars.shape[0] if lead else scalars.shape[-1]
    at = (lambda i: scalars[i]) if lead else (lambda i: scalars[..., i])
    word, off = divmod(w * c, 32)
    v = at(word) >> off if word < nw else torch.zeros_like(at(0))
    if off and word + 1 < nw:
        v = v | (at(word + 1) << (32 - off))
    return v & ((1 << c) - 1)


def signed_digit_carries(scalars, c: int, bits: int = SCALAR_BITS,
                         lead: bool = False):
    """Carry bits of the signed recode packed as (2, *b, n) u32 bitmasks
    (bit w = carry INTO window w)."""
    nwin = -(-bits // c)
    assert nwin <= 64
    half = 1 << (c - 1)
    sc = scalars if lead else _u32(scalars)
    z = _raw_digit(sc, 0, c, lead)
    out = [torch.zeros_like(z), torch.zeros_like(z)]
    carry = torch.zeros_like(z)
    for w in range(nwin):
        d = _raw_digit(sc, w, c, lead) + carry
        carry = (d >= half).to(torch.int64)
        if w + 1 < nwin:
            word, bit = divmod(w + 1, 32)
            out[word] = out[word] | (carry << bit)
    return torch.stack(out)


def group_signed_digits(scalars9, carry_bits, w0: int, G: int, c: int,
                        lead: bool = False):
    """ENCODED signed digits |d|*2 + (d<0) of windows w0..w0+G-1:
    (G, *b, n) int64. scalars9 carries one zero pad word (trailing, or
    leading row with lead=True)."""
    half, full = 1 << (c - 1), 1 << c
    sc = scalars9 if lead else _u32(scalars9)
    rows = []
    for j in range(G):
        w = w0 + j
        word, off = divmod(w * c, 32)
        lo = sc[word] if lead else sc[..., word]
        hi = sc[word + 1] if lead else sc[..., word + 1]
        v = (lo >> off) | ((hi << (32 - off)) if off else 0)
        d = v & (full - 1)
        cw = (carry_bits[0] >> w) if w < 32 else (carry_bits[1] >> (w - 32))
        d = d + (cw & 1)
        dd = torch.where(d >= half, d - full, d)
        rows.append(dd.abs() * 2 + (dd < 0).to(torch.int64))
    return torch.stack(rows)


def _row_layout(t: torch.Tensor, tail: tuple, name: str):
    """(rows, n, row stride in words) of a (*lead, n, *tail) int32 tensor
    on the card (or the CPU, for a model of a kernel's launch) whose rows
    of n entries are each contiguous and whose leading axes merge into
    one stride (a slice of a contiguous tensor along n qualifies); raises
    on anything else."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected torch.int32, got {t.dtype}")
    k = len(tail)
    if t.dim() < k + 1 or tuple(t.shape[-k:]) != tuple(tail):
        raise ValueError(f"{name}: shape {tuple(t.shape)} is not (..., n, "
                         f"{', '.join(map(str, tail))})")
    inner = 1
    for d in range(t.dim() - 1, t.dim() - k - 2, -1):
        if t.shape[d] > 1 and t.stride(d) != inner:
            raise ValueError(f"{name}: rows of shape {tuple(t.shape)} "
                             f"strides {t.stride()} are not contiguous")
        inner *= t.shape[d]
    lead = t.dim() - k - 1
    n = t.shape[lead]
    rows, stride = 1, inner
    for d in range(lead - 1, -1, -1):
        if t.shape[d] == 1:
            continue
        if rows > 1 and t.stride(d) != stride * rows:
            raise ValueError(f"{name}: leading axes of strides {t.stride()} "
                             "do not merge")
        if rows == 1:
            stride = t.stride(d)
        rows *= t.shape[d]
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data is not 16-byte aligned")
    return rows, n, stride


# ---------------------------------------------------------------------------
# scalar and point preparation kernels (csrc/msm.cu)
# ---------------------------------------------------------------------------

def _glv_consts(params) -> ctypes.Array:
    """glv_digits' 34 constant words: g1, g2 (5 words each), t1a, t2a,
    t1b, t2b (6 words each)."""
    words = []
    for v, nw in ((params.g1, 5), (params.g2, 5), (params.t1a, 6),
                  (params.t2a, 6), (params.t1b, 6), (params.t2b, 6)):
        if v >> (32 * nw):
            raise ValueError("glv_digits: a GLV constant is too wide")
        words += [(v >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]
    return (ctypes.c_uint32 * len(words))(*words)


def glv_digits_plain(scalars, c: int, w0: int, G: int, params=None,
                     half=None):
    if params is None:
        s9 = _pad_word(scalars)
        return group_signed_digits(s9, signed_digit_carries(s9, c), w0, G,
                                   c)
    words, neg = GLV.decompose(params, scalars)
    if half is not None:
        n = scalars.shape[-2]
        words = words[..., half * n:(half + 1) * n]
        neg = neg[..., half * n:(half + 1) * n]
    carries = signed_digit_carries(words, c, GLV.GLV_BITS, lead=True)
    return group_signed_digits(words, carries, w0, G, c,
                               lead=True) ^ neg[None]


def glv_digits(scalars: torch.Tensor, c: int, w0: int, G: int,
               params=None, half=None) -> torch.Tensor:
    """The encoded signed digits |d|*2 + (d<0) of windows w0 .. w0+G-1 of
    each scalar's signed recode into c-bit windows: (G, *b, H*n) int64.

    scalars: (*b, n, 8) packed words (rows of n contiguous scalars). With
    `params` (ops/glv.GLVParams) every scalar splits by GLV into k1 and k2
    (ops/glv.decompose), each recoded over 128 bits with every digit's
    sign bit flipped where its half is negative: half=0 or 1 gives that
    half alone (H = 1), half=None both as [k1 | k2] along the entry axis
    (H = 2). Without `params` the 256-bit scalar itself (H = 1)."""
    bits = SCALAR_BITS if params is None else GLV.GLV_BITS
    if not 1 <= c <= 16:
        raise ValueError(f"glv_digits: window bits {c} not in 1..16")
    nwin = -(-bits // c)
    if nwin > 64 or w0 < 0 or G < 1 or w0 + G > nwin:
        raise ValueError(f"glv_digits: windows {w0}..{w0 + G - 1} of "
                         f"{nwin} (at most 64)")
    if half not in (None, 0, 1) or (params is None and half is not None):
        raise ValueError(f"glv_digits: half {half!r} without a GLV split "
                         "or not 0 / 1")
    if scalars.device.type == "cpu":
        return glv_digits_plain(scalars, c, w0, G, params, half)
    rows, n, stride = _row_layout(scalars, (8,), "glv_digits.scalars")
    nh = 2 if params is not None and half is None else 1
    out = torch.empty((G,) + tuple(scalars.shape[:-2]) + (nh * n,),
                      dtype=torch.int64, device=scalars.device)
    consts = None if params is None else _glv_consts(params)
    rc = D.lib("msm").rs_glv_digits(
        scalars.data_ptr(), rows, stride, n,
        None if consts is None else ctypes.addressof(consts), half or 0, nh,
        c, w0, G, out.data_ptr(), D.stream(scalars))
    D.check(rc, "glv_digits")
    D.count("glv_digits")
    return out


# the kinds of fq_scale's work items (csrc/msm.cu SC_*); a copied
# component is no item: the kernel's tile loads and stores move it
SCALE_NEG, SCALE_NEG_RX, SCALE_MUL, SCALE_MUL2 = 1, 2, 3, 4
_SCALE_KINDS = {"neg": SCALE_NEG, "neg_rx": SCALE_NEG_RX}
SCALE_KW = 72           # constant words: 6 components, 3 Fq2 sums
SCALE_WT = 32           # points a warp's tile (csrc SCALE_WT)


class ScalePlan(NamedTuple):
    """fq_scale's launch for one spec: `items` [(kind, component)], one
    a negated or an Fq-scaled component or an Fq2-scaled coordinate (its
    first component), none for a copy, in spec order; `code` packs them
    6 bits each; `consts` the SCALE_KW words."""
    items: tuple
    code: int
    consts: ctypes.Array


@functools.lru_cache(maxsize=None)
def _scale_plan(spec: tuple, ext: int) -> ScalePlan:
    """The plan of a spec, made once a process (the wrapper's calls reuse
    its packed constants)."""
    items, words = [], [0] * SCALE_KW
    for m, op in enumerate(spec):
        if op is None:
            continue
        if isinstance(op, str):
            items += [(_SCALE_KINDS[op], m * ext + e) for e in range(ext)]
            continue
        vals = (op,) if ext == 1 else tuple(op)
        items.append((SCALE_MUL if ext == 1 else SCALE_MUL2, m * ext))
        for e, val in enumerate(vals):
            j = m * ext + e
            words[8 * j:8 * j + 8] = _int_words(val % _P)
        if ext == 2:
            words[8 * (6 + m):8 * (7 + m)] = _int_words(
                vals[0] % _P + vals[1] % _P)
    code = sum((kind | j << 3) << (6 * q) for q, (kind, j) in
               enumerate(items))
    return ScalePlan(tuple(items), code,
                     (ctypes.c_uint32 * SCALE_KW)(*words))


def _int_words(v: int):
    return [(v >> (32 * w)) & 0xFFFFFFFF for w in range(8)]


def fq_scale_plain(t, spec, ext: int = 1):
    comps = [t[..., j, :] for j in range(t.shape[-2])]
    out = []
    for m, op in enumerate(spec):
        cs = comps[m * ext:(m + 1) * ext]
        if op is None:
            out += cs
        elif op in ("neg", "neg_rx"):
            fn = FQ.neg if op == "neg" else FQ.neg_rx
            out += [FF.pack(fn(FF.unpack(x))) for x in cs]
        elif ext == 1:
            x = FF.unpack(cs[0])
            out.append(FF.pack(FQ.mul(x, FQ.const(op, tuple(x.shape[1:]),
                                                  x.device))))
        else:
            x = (FF.unpack(cs[0]), FF.unpack(cs[1]))
            k = FQ2.const(op, tuple(x[0].shape[1:]), x[0].device)
            out += [FF.pack(e) for e in FQ2.mul_many([(x, k)])[0]]
    return torch.stack(out, dim=-2)


def fq_scale(t: torch.Tensor, spec, ext: int = 1) -> torch.Tensor:
    """Packed points (*b, n, A, 8) (or (..., A, 8) of any leading shape)
    coordinate by coordinate: `spec` has one entry for each of the A/ext
    coordinates (ext = 1: Fq components, 2: Fq2 pairs): None copies it,
    "neg" negates it canonically (p - a, 0 for 0), "neg_rx" as the
    relaxed G1 law does (2p - a), and a Montgomery constant (an int for
    ext 1, a pair for ext 2) multiplies it (canonical out). Returns a new
    contiguous tensor of t's shape."""
    A = t.shape[-2]
    if t.dim() < 2 or t.shape[-1] != 8 or ext not in (1, 2) or \
            len(spec) * ext != A or A > 6:
        raise ValueError(f"fq_scale: {len(spec)} coordinates of {ext} "
                         f"components for points {tuple(t.shape)}")
    for op in spec:
        if not (op in (None, "neg", "neg_rx")
                if isinstance(op, (str, type(None)))
                else (isinstance(op, int) if ext == 1 else
                      isinstance(op, tuple) and len(op) == 2)):
            raise ValueError(f"fq_scale: {op!r} is no op of an ext-{ext} "
                             "coordinate")
    if t.device.type == "cpu":
        return fq_scale_plain(t, spec, ext)
    v = t if t.dim() >= 3 else t[None]
    rows, n, stride = _row_layout(v, (A, 8), "fq_scale")
    plan = _scale_plan(tuple(spec), ext)
    out = torch.empty(t.shape, dtype=torch.int32, device=t.device)
    rc = D.lib("msm").rs_fq_scale(
        v.data_ptr(), rows, stride, n, A, plan.code, len(plan.items),
        ctypes.addressof(plan.consts), out.data_ptr(), D.stream(t))
    D.check(rc, "fq_scale")
    D.count("fq_scale")
    return out


def group_size(nwin: int, window_group: int) -> int:
    """The windows msm scans at once: window_group, cut to the largest
    divisor of the window count nwin that is no larger."""
    g = min(window_group, nwin)
    while nwin % g:
        g -= 1
    return g


def pad_len(n: int) -> int:
    return max(_CHUNK, -(-n // _CHUNK) * _CHUNK)


# ---------------------------------------------------------------------------
# MSM core
# ---------------------------------------------------------------------------

# digit_sort's plan (csrc/sort.cu SORT_TILE, SORT_MAX_BITS, COUNT_CHUNK,
# CTR_WORDS; a status word's count has 30 bits)
SORT_TILE = 8192        # keys a block of a scatter pass ranks at once
SORT_MAX_BITS = 10      # bits of the widest radix pass
COUNT_CHUNK = 32768     # keys a block of the counting pass reads
SORT_CTR_WORDS = 32     # the scatter passes' tile counters
SORT_MAX_ROW = (1 << 30) - 1


class SortPlan(NamedTuple):
    """digit_sort's launches for R rows of n keys of c + 1 bits: `passes`
    (shift, bits) low bits first, one scatter launch each; `tile` keys a
    block of a scatter ranks, `tiles` a row; `chunks` blocks a row of the
    counting pass; `bins` the passes' digits together; `status_words`
    the scatters' look-back words (a (row, tile, digit) of every pass);
    `work_words` the int32 workspace (tile counters, status words, the
    counting pass's partial histograms, the digit bases);
    `workspace_bytes` with two passes also the packed intermediate (8 B
    a key); `traffic_bytes` what the launches move in device memory
    (the design's own floor, beside the function's 20 B a key)."""
    passes: tuple
    tile: int
    tiles: int
    chunks: int
    bins: int
    status_words: int
    work_words: int
    workspace_bytes: int
    traffic_bytes: int


def sort_plan(c: int, n: int, rows: int) -> SortPlan:
    if not 1 <= c <= 16:
        raise ValueError(f"digit_sort: window bits {c} not in 1..16")
    if n > SORT_MAX_ROW:
        raise ValueError(f"digit_sort: a row of {n} keys passes the "
                         f"look-back's 30-bit count ({SORT_MAX_ROW})")
    bits = c + 1
    npass = -(-bits // SORT_MAX_BITS)
    b0 = -(-bits // npass)
    passes = tuple((p * b0, min(b0, bits - p * b0)) for p in range(npass))
    bins = sum(1 << b for _, b in passes)
    tiles = -(-n // SORT_TILE)
    chunks = -(-n // COUNT_CHUNK)
    status = rows * tiles * bins
    work = SORT_CTR_WORDS + status + rows * (chunks + 1) * bins
    mid = 8 * rows * n if npass > 1 else 0
    keys = rows * n
    # the count reads the int64 keys; a pass reads 8 B a key (the keys or
    # the packed words) and writes 8 (packed words, or key and index);
    # the tail reads the sorted keys and writes the signs and boundaries.
    # A status word is zeroed, published twice and read once, a partial
    # count and a digit base written and read once
    partials = rows * chunks * bins
    traffic = (8 * keys + 16 * keys * npass + 8 * keys
               + 4 * rows * ((1 << (c - 1)) + 1)
               + 16 * status + 8 * (partials + rows * bins))
    return SortPlan(passes, SORT_TILE, tiles, chunks, bins, status, work,
                    mid + 4 * work, traffic)


def digit_sort_plain(digits, c: int):
    bshape, n = tuple(digits.shape[:-1]), digits.shape[-1]
    M = 1 << (c - 1)
    keys, perm = torch.sort(digits, dim=-1, stable=True)
    sign = (keys & 1).to(torch.int32).reshape(
        bshape + (n // _CHUNK, _CHUNK)).movedim(-1, 0).contiguous()
    # bucket boundary of |d| <= j in the encoded order: key 2j+1
    queries = 2 * torch.arange(M + 1, device=digits.device) + 1
    flat = keys.reshape(-1, n)
    cum = torch.searchsorted(flat, queries.expand(flat.shape[0], M + 1)
                             .contiguous(), right=True, out_int32=True)
    return (keys.to(torch.int32), perm.to(torch.int32), sign,
            cum.reshape(bshape + (M + 1,)))


def digit_sort(digits: torch.Tensor, c: int):
    """The bucket order of a window group's encoded digits.

    digits: (G, *b, n) int64 encoded signed digits |d|*2 + (d<0), each
    below 2^(c+1) (glv_digits), n a multiple of 256. Returns, row by row
    (a row: one window of one table row):
      keys  (G, *b, n) int32, the digits in ascending order, stable;
      perm  (G, *b, n) int32, the entry each sorted key came from;
      sign  (256, G, *b, n/256) int32, keys & 1 in the scan's column
            layout (column c of chunk k holds sorted entry k*256 + c);
      cum   (G, *b, 2^(c-1) + 1) int32, the count of keys <= 2j+1: the
            end of bucket |d| <= j.
    Keys are checked against 2^(c+1) on the CPU only (the card would
    need a host sync)."""
    if not 1 <= c <= 16:
        raise ValueError(f"digit_sort: window bits {c} not in 1..16")
    if digits.dtype != torch.int64 or digits.dim() < 1:
        raise ValueError(f"digit_sort: expected (..., n) torch.int64 digits,"
                         f" got {tuple(digits.shape)} {digits.dtype}")
    n = digits.shape[-1]
    if n < _CHUNK or n % _CHUNK:
        raise ValueError(f"digit_sort: rows of {n} keys are not whole "
                         f"chunks of {_CHUNK}")
    rows = digits.numel() // n
    if rows * n >= 1 << 31:
        raise ValueError(f"digit_sort: {rows} x {n} keys pass 2^31")
    plan = sort_plan(c, n, rows)
    if digits.device.type == "cpu":
        if digits.numel() and (int(digits.min()) < 0
                               or int(digits.max()) >> (c + 1)):
            raise ValueError(f"digit_sort: a key outside 0 .. 2^{c + 1} - 1")
        return digit_sort_plain(digits, c)
    D.require(digits, "digit_sort.digits", torch.int64)
    bshape = tuple(digits.shape[:-1])
    dev = digits.device

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    keys, perm = i32(*digits.shape), i32(*digits.shape)
    sign = i32(_CHUNK, *bshape, n // _CHUNK)
    cum = i32(*bshape, (1 << (c - 1)) + 1)
    two = len(plan.passes) > 1
    mid = (torch.empty((rows, n), dtype=torch.int64, device=dev) if two
           else None)
    ws = i32(plan.work_words)
    rc = D.lib("sort").rs_digit_sort(
        digits.data_ptr(), rows, n, c, keys.data_ptr(), perm.data_ptr(),
        sign.data_ptr(), cum.data_ptr(), mid.data_ptr() if two else None,
        ws.data_ptr(), plan.work_words, D.stream(digits))
    D.check(rc, "digit_sort")
    D.count("digit_sort")
    return keys, perm, sign, cum


def gather_cols_plain(pts, perm):
    bshape = tuple(perm.shape[:-1])
    nb = perm.shape[-1] // _CHUNK
    pc = perm.reshape(bshape + (nb, _CHUNK)).movedim(-1, 0)
    bidx = _batch_index((_CHUNK,) + bshape + (nb,), pts.dim() - 1,
                        pts.device)[2:]
    return pts[(*bidx, pc)].contiguous()


def gather_cols(pts, perm):
    """The MSM's point gather, straight into the scan's column layout.

    pts: packed affine (*b, n, A, 8) whose rows of n entries are each
    contiguous; perm: (G, *b, n) entry indices (the sort's permutation;
    int32 on the card). Returns (C, G, *b, n/C, A, 8) with column c of
    chunk k holding pts[perm[k*C + c]]. Indices are not checked against
    n on the card."""
    if pts.dim() < 3 or pts.shape[-1] != 8:
        raise ValueError(f"gather_cols: points {tuple(pts.shape)} are not "
                         "(..., n, A, 8)")
    bsh, n, A = tuple(pts.shape[:-3]), pts.shape[-3], pts.shape[-2]
    if perm.dim() != len(bsh) + 2 or tuple(perm.shape[1:]) != bsh + (n,):
        raise ValueError(f"gather_cols: permutation {tuple(perm.shape)} is "
                         f"not (G, {', '.join(map(str, bsh + (n,)))})")
    if n < _CHUNK or n % _CHUNK:
        raise ValueError(f"gather_cols: {n} entries are not whole chunks "
                         f"of {_CHUNK}")
    if pts.device != perm.device:
        raise ValueError(f"gather_cols: points on {pts.device}, permutation "
                         f"on {perm.device}")
    if pts.device.type == "cpu":
        return gather_cols_plain(pts, perm)
    D.require(perm, "gather_cols.perm", torch.int32)
    rows, _, stride = _row_layout(pts, (A, 8), "gather_cols.pts")
    if stride % 4:
        raise ValueError(f"gather_cols: table rows {stride} words apart are "
                         "not 16-byte aligned")
    G = perm.shape[0]
    out = torch.empty((_CHUNK, G) + bsh + (n // _CHUNK, A, 8),
                      dtype=torch.int32, device=pts.device)
    rc = D.lib("gather").rs_gather_cols(
        pts.data_ptr(), rows, stride, n, A, perm.data_ptr(), G,
        out.data_ptr(), D.stream(pts))
    D.check(rc, "gather_cols")
    D.count("gather_cols")
    return out


def _window_group(curve, pts, digits, n: int, c: int):
    """Window totals sum_j j*B_j of a group of windows, telescoped.

    pts: packed affine (*b, n, A, 8); digits: (G, *b, n) encoded signed
    digits. Returns packed projective (G, *b, L, 8)."""
    bshape = tuple(digits.shape[:-1])            # (G, *b)
    M = 1 << (c - 1)
    dev = digits.device
    with phase("msms.sort", device=dev):
        keys, perm, sign, cum = digit_sort(digits, c)
    del keys
    if counting():               # cum[..., 0]: the keys of digit 0
        count("count.msms.entries", digits.numel())
        count("count.msms.live", digits.numel() - cum[..., 0].sum(
            dtype=torch.int64))
    with phase("msms.gather", device=dev):
        cols = gather_cols(pts, perm)             # (C, G, *b, nb, A, 8)
    del perm
    with phase("msms.scan", device=dev):
        within, excl = _chunked_prefix(curve, cols, sign, bshape,
                                       n // _CHUNK)
    del cols, sign
    with phase("msms.buckets", device=dev):
        A = _ps_at(curve, within, excl, cum)
        del within, excl
        top = A[..., M:, :, :].expand(bshape + (M,) + tuple(A.shape[-2:]))
        head = A[..., :M, :, :]
        diff = fused.add(curve, top.contiguous(), point_neg(curve, head))
        return _tree_total(curve, diff, M)


def _phi(curve, pts):
    """phi(x, y) = (beta*x, y) on a packed affine table (*b, n, A, 8),
    each x component times the Fq constant beta (fq_scale); (0,0) is
    fixed by phi."""
    beta = GLV.params_for(curve).beta_mont
    nx = 2 if is_g2(curve) else 1
    return fq_scale(pts, (beta,) * nx + (None,) * nx)


def _table_slice(curve, pts, off: int, size: int):
    """Entries off .. off+size of the virtual GLV table [P, phi(P)]
    (*b, 2n, A, 8) of a table (*b, n, A, 8), for a range that lies in one
    half or is the whole axis: the lower part is a view, the upper part
    the phi image of that part only."""
    npts = pts.shape[-3]
    if off >= npts:
        return _phi(curve, pts[..., off - npts:off - npts + size, :, :])
    lower = pts[..., off:off + min(size, npts - off), :, :]
    if off + size <= npts:
        return lower
    assert off == 0 and size == 2 * npts
    return torch.cat([lower, _phi(curve, pts)], dim=-3)


def _pad_word(scalars):
    """(*b, n, 8) -> (*b, n, 9): the zero pad word group_signed_digits
    reads past the top window."""
    return torch.cat([scalars, torch.zeros_like(scalars[..., :1])], dim=-1)


def _segmented_groups(sc, pts, scalars, c: int, G_: int, nwin: int,
                      segment: int, glv: bool):
    """Window totals by slices of `segment` entries of the entry axis;
    every slice adds one point per window into the running totals.

    With GLV the axis is the virtual [k1 | k2] one: entry `off` maps to
    table point off % npts, no slice straddles the k1/k2 boundary, so
    each slice's scalars are decomposed on their own and the decomposed
    stack of the whole axis never exists. Without it the axis is the
    table's. Returns the list of per-group totals (G_, *b, L, 8)."""
    npts = scalars.shape[-2]
    if npts % segment or segment % _CHUNK:
        raise ValueError(f"msm: segment {segment} must divide {npts} points "
                         f"and be a multiple of {_CHUNK}")
    bshape = tuple(scalars.shape[:-2])
    ngroups = nwin // G_
    accs = [point_inf(sc, (G_,) + bshape, scalars.device)
            for _ in range(ngroups)]
    dev = scalars.device
    for off in range(0, 2 * npts if glv else npts, segment):
        offp = off % npts
        scseg = scalars[..., offp:offp + segment, :]
        with phase("msms.prep", device=dev):
            if glv:
                pseg = _table_slice(sc, pts, off, segment)
                dseg = glv_digits(scseg, c, 0, nwin, GLV.params_for(sc),
                                  half=int(off >= npts))
            else:
                pseg = pts[..., off:off + segment, :, :]
                dseg = glv_digits(scseg, c, 0, nwin)
        for ig in range(ngroups):
            t = _window_group(sc, pseg, dseg[ig * G_:(ig + 1) * G_],
                              segment, c)
            with phase("msms.buckets", device=dev):
                accs[ig] = fused.add(sc, accs[ig], t.contiguous())
    return accs


def _iso_scale(curve, pt, back: bool):
    """Packed projective points (..., 6, 8) between G2's twist and the
    iso-twist the scan and the add kernel run on: (x*w2, y*w3, z), or
    with back=True (x/w2, y/w3, z)."""
    iso = curve.iso_scan.iso
    return fq_scale(pt, (iso["w2i" if back else "w2"],
                         iso["w3i" if back else "w3"], None), ext=2)


def _horner(curve, wpts, nwin: int, c: int):
    """sum_w 2^(wc) wpts[w] from the top window down: c doublings (the
    complete adder on (acc, acc): its tangent path) and one add per
    window, every step one ops/fused.add. The ladder starts from the top
    window's total, so the leading identity steps are never launched."""
    acc = wpts[nwin - 1].contiguous()
    for w in range(nwin - 2, -1, -1):
        for _ in range(c):
            acc = fused.add(curve, acc, acc)
        acc = fused.add(curve, acc, wpts[w].contiguous())
    return acc


def _combine_windows(curve, wpts, nwin: int, c: int):
    """Horner combine of the window totals on the device.

    wpts: packed projective (W, *batch, L, 8) on `curve`, as msm returns
    them with combine=False. Returns one point per batch row,
    (*batch, L, 8), on `curve`. G2 totals ride the iso-twist through the
    ladder (the adder serves that twist) and are scaled back at the end."""
    if getattr(curve, "iso_scan", None) is None:
        return _horner(curve, wpts, nwin, c)
    tot = _horner(curve.iso_scan, _iso_scale(curve, wpts, back=False),
                  nwin, c)
    return _iso_scale(curve, tot, back=True)


def msm(curve, pts, scalars, c: int, window_group: int = 5,
        combine: bool = False, segment: int = 0, row_slice=None, glv=None):
    """Multi-scalar multiplication, batched over leading axes.

    pts: packed affine (*batch, n, A, 8), n % 256 == 0, (0,0) padding
    (on G2 already rescaled onto the iso-twist, g2_rescale_packed);
    scalars: (*batch, n, 8) packed plain integers. Returns the window
    totals as packed projective points (W, *batch, L, 8) on `curve`,
    for the Horner combine on the host (combine=False, the default here:
    the Prover combines on the host). With combine=True (the JAX
    package's default) the ladder runs on the device and the result is
    one packed projective point per batch row, (*batch, L, 8).

    `segment` (a multiple of 256 dividing n, 0 = off) runs the scan in
    slices of the entry axis, which bounds the scan's working set (the
    all-positions prefix is 96-192 bytes per entry per window of a
    group). `row_slice=(row_lo, nrows)` selects nrows leading-axis rows
    of a bigger scalar stack (a view, never a copy).

    `glv` (None: ops/glv.enabled(), i.e. on unless RSTPU_GLV=0) splits
    every scalar into two 128-bit halves over the 2n-entry virtual table
    [P, phi(P)]: ceil(128/c) windows. With glv=False the table itself is
    scanned over ceil(256/c) windows, no phi image and no sign fold."""
    if glv is None:
        glv = GLV.enabled()
    if row_slice is not None:
        row_lo, nrows = row_slice
        scalars = scalars[row_lo:row_lo + nrows]
    bshape = tuple(scalars.shape[:-2])
    npts = scalars.shape[-2]
    n = 2 * npts if glv else npts
    bits = GLV.GLV_BITS if glv else SCALAR_BITS
    nwin = -(-bits // c)
    G_ = group_size(nwin, window_group)
    iso = getattr(curve, "iso_scan", None)
    sc = iso or curve
    if segment and segment < n:
        groups = _segmented_groups(sc, pts, scalars, c, G_, nwin, segment,
                                   glv)
    else:
        with phase("msms.prep", device=scalars.device):
            if glv:
                digits = glv_digits(scalars, c, 0, nwin,
                                    GLV.params_for(curve))
                p2 = _table_slice(sc, pts, 0, n)
            else:
                digits, p2 = glv_digits(scalars, c, 0, nwin), pts
        groups = [_window_group(sc, p2, digits[ig * G_:(ig + 1) * G_], n, c)
                  for ig in range(nwin // G_)]
    wpts = torch.cat(groups, dim=0)                # (W, *b, L, 8) on sc
    assert wpts.shape[:1 + len(bshape)] == (nwin,) + bshape
    if combine:
        wpts = _horner(sc, wpts, nwin, c)          # (*b, L, 8)
    if iso is not None:
        wpts = _iso_scale(curve, wpts, back=True)
    return wpts


# ---------------------------------------------------------------------------
# zkey-layout helpers
# ---------------------------------------------------------------------------

def g2_rescale_packed(pts):
    """Rescale a packed G2 affine table (..., 4, 8) onto the iso-twist
    G2P_ISO: (x*w2, y*w3) through fq_scale; (0,0) is fixed."""
    return fq_scale(pts, (G2P_ISO.iso["w2"], G2P_ISO.iso["w3"]), ext=2)
