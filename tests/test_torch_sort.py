"""The MSM's bucket ordering of the port on the CPU: ops/msm.digit_sort
(the stable sort of a window group's encoded digits, its permutation,
the sign columns and the bucket boundaries) and ops/msm.gather_cols (the
sorted points in the scan's column layout), each against the JAX
package on the same numpy inputs, and each kernel's launch modelled.

digit_sort is held against the JAX package's `jax.lax.sort_key_val` of
the digits with an iota (sorted keys and permutation), `jnp.searchsorted
(..., 2j+1, side="right")` (the boundaries) and `sorted & 1` moved into
the scan's column layout, as rapidsnark_tpu/ops/msm.py `_window_group`
builds them; gather_cols against the JAX package's `_gather_last` on the
same packed table (convert.py's word layout) moved into that layout. The
models run csrc/sort.cu's launches (sort_plan's bit ranges; the counting
pass's partial histograms of every pass's digits, the scan of them into
digit bases, each scatter pass's stable warp ranks and decoupled
look-back with its tiles published in a given order, the packed 64-bit
intermediate, the tail's sign runs and boundary writes with its list of
long runs) and csrc/gather.cu's blocks (index spans, the (column, chunk,
piece) items) with the kernels' index arithmetic in numpy. Sizes: n in
{256, 4096, 4352} (one tile a row) and 3 tiles + 256 keys (the
look-back's tile orders: launch, reversed, a seeded shuffle), G = 2
windows of 2-4 table rows, c in {4, 8, 9, 13, 16}, and the edge tables:
all keys 0, keys 0 and 1 only, every key 2^(c+1) - 1, one row of exactly
256, descending keys, one key value in every tile. Tolerance: exact
words (integers)."""

import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidsnark_tpu.ops import msm as JM
from rapidsnark_tpu_torch import convert
from rapidsnark_tpu_torch import device as D
from rapidsnark_tpu_torch.ops import fused as TFU
from rapidsnark_tpu_torch.ops import msm as TM
from rapidsnark_tpu_torch.ops.curve import G1P

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)

CS = [4, 8, 9, 13, 16]
C = 256
# csrc/sort.cu: warps and keys a thread of a scatter block; chunks a
# block of k_sort_tail, the boundaries a thread of it writes, the longer
# runs a block lists
W, KPT = 16, 16
TAIL_SPAN, TAIL_RUN, TAIL_GAPS = 32, 32, 1024
ORDERS = ["launch", "reversed", 7]
EDGES = ["zeros", "zero_one", "top", "one_row_256", "descending",
         "one_value_per_tile"]


def _digits(seed, shape, c):
    """Encoded signed digits |d|*2 + (d<0), |d| <= 2^(c-1), with padding
    zeros, as glv_digits writes them."""
    rng = np.random.RandomState(seed)
    mag = rng.randint(0, (1 << (c - 1)) + 1, size=shape)
    neg = rng.randint(0, 2, size=shape) * (mag > 0)
    d = mag * 2 + neg
    d[..., : shape[-1] // 7] = 0
    return d.astype(np.int64)


def _edge(kind, c, seed=3):
    rng = np.random.RandomState(seed)
    top = 1 << (c + 1)
    if kind == "zeros":
        return np.zeros((2, 4, 4096), np.int64)
    if kind == "zero_one":
        return rng.randint(0, 2, size=(2, 4, 4096)).astype(np.int64)
    if kind == "top":
        return np.full((2, 4, 4096), top - 1, np.int64)
    if kind == "one_row_256":
        return rng.randint(0, top, size=(1, 256)).astype(np.int64)
    if kind == "descending":
        d = np.sort(rng.randint(0, top, size=(2, 4, 4352)), axis=-1)
        return d[..., ::-1].astype(np.int64).copy()
    assert kind == "one_value_per_tile"
    n = 3 * TM.SORT_TILE + 256
    tile = np.arange(n) // TM.SORT_TILE
    vals = (tile[None, None, :] * 5 + 1 + np.arange(4)[None, :, None]
            + 7 * np.arange(2)[:, None, None]) % top
    return vals.astype(np.int64)


@jax.jit
def _jax_sort(d):
    iota = jax.lax.broadcasted_iota(jnp.int32, d.shape, d.ndim - 1)
    return jax.lax.sort_key_val(d, iota, dimension=-1)


def _jax_bucket_order(digits, c):
    """The JAX package's sort, signs and boundaries (its _window_group)."""
    M = 1 << (c - 1)
    n = digits.shape[-1]
    sd, perm = _jax_sort(jnp.asarray(digits.astype(np.int32)))
    queries = 2 * jnp.arange(M + 1, dtype=jnp.int32) + 1
    cum = jax.vmap(lambda r: jnp.searchsorted(r, queries, side="right"))(
        sd.reshape(-1, n)).reshape(digits.shape[:-1] + (M + 1,))
    sd = np.asarray(sd)
    sign = np.moveaxis((sd & 1).reshape(digits.shape[:-1] + (n // C, C)),
                       -1, 0)
    return sd, np.asarray(perm), sign, np.asarray(cum)


def _tile_order(order, tiles):
    """The order in which a scatter pass's blocks publish their tiles:
    "launch", "reversed", or a seeded shuffle."""
    if order == "launch":
        return list(range(tiles))
    if order == "reversed":
        return list(range(tiles))[::-1]
    return list(np.random.RandomState(order).permutation(tiles))


def _model_sort(digits, c, order="launch"):
    """csrc/sort.cu rs_digit_sort on (R, n) keys, launch by launch: the
    counting pass, the scan of its counts, the scatter passes (their
    tiles published and looked back in `order`: _tile_order's) and the
    tail."""
    shape = digits.shape
    n = shape[-1]
    keys = digits.reshape(-1, n).astype(np.int64)
    R = keys.shape[0]
    plan = TM.sort_plan(c, n, R)
    T, ntiles, run = plan.tile, plan.tiles, 32 * KPT
    offs = np.cumsum([0] + [1 << b for _, b in plan.passes])
    rows = np.arange(R)[:, None]
    # k_sort_count: a block a (row, chunk) counts every pass's digits of
    # its keys (the pass's bits of the key itself)
    partial = np.zeros((R, plan.chunks, plan.bins), np.int64)
    for p, (shift, bits) in enumerate(plan.passes):
        np.add.at(partial, (rows, (np.arange(n) // TM.COUNT_CHUNK)[None, :],
                            offs[p] + ((keys >> shift) & ((1 << bits) - 1))),
                  1)
    # k_sort_scan: a block a (row, pass); base = row * n + the row's keys
    # with a lower digit of the pass
    tot = partial.sum(axis=1)
    base = np.zeros_like(tot)
    for p in range(len(plan.passes)):
        seg = tot[:, offs[p]:offs[p + 1]]
        base[:, offs[p]:offs[p + 1]] = rows * n + np.cumsum(seg, 1) - seg
    vals = None
    for p, (shift, bits) in enumerate(plan.passes):
        nbins = 1 << bits
        last = p == len(plan.passes) - 1
        dig = (keys >> shift) & (nbins - 1)
        # each block's own work: warp w takes the w-th run of 32 * KPT
        # keys in rounds of 32; a key's rank: the earlier keys of its
        # digit in its run (the rounds' counters and the multisplit's lower
        # peers); the warps' counts scanned in warp order; slots by digit
        local = []
        for t in range(R * ntiles):
            r, tile = divmod(t, ntiles)
            lo, valid = tile * T, min(T, n - tile * T)
            dt = dig[r, lo:lo + valid]
            w = np.arange(valid) // run
            grp = w * nbins + dt
            o = np.argsort(grp, kind="stable")
            rk = np.empty(valid, np.int64)
            rk[o] = np.arange(valid) - np.searchsorted(grp[o], grp[o])
            wc = np.zeros((W, nbins), np.int64)
            np.add.at(wc, (w, dt), 1)
            cnt = wc.sum(axis=0)
            dstart = np.cumsum(cnt) - cnt
            slot = dstart[dt] + (np.cumsum(wc, 0) - wc)[w, dt] + rk
            assert sorted(slot) == list(range(valid))
            local.append((slot, cnt, dstart))
        # the look-back: status words (flag, count) a (tile, digit); the
        # tiles publish their counts in `order` (a row's tile 0 as its
        # inclusive prefix); after each, every waiting tile walks back
        # over aggregates until an inclusive prefix, or waits on a tile
        # that has published nothing
        flag = np.zeros(R * ntiles, np.int64)          # 0, AGG 1, INC 2
        count = np.zeros((R * ntiles, nbins), np.int64)
        prefix = {}
        waiting = []
        for t in _tile_order(order, R * ntiles):
            first = t % ntiles == 0
            flag[t], count[t] = (2 if first else 1), local[t][1]
            if first:
                prefix[t] = np.zeros(nbins, np.int64)
            else:
                waiting.append(t)
            moved = True
            while moved:
                moved = False
                for u in list(waiting):
                    acc, pt = np.zeros(nbins, np.int64), u - 1
                    while flag[pt] == 1:
                        acc += count[pt]
                        pt -= 1
                    if flag[pt] == 0:
                        continue
                    prefix[u] = acc + count[pt]
                    flag[u], count[u] = 2, prefix[u] + local[u][1]
                    waiting.remove(u)
                    moved = True
        assert not waiting and (flag == 2).all()
        okeys = np.full(R * n, -1, np.int64)
        ovals = np.full(R * n, -1, np.int64)
        for t in range(R * ntiles):
            r, tile = divmod(t, ntiles)
            slot, cnt, dstart = local[t]
            before = np.zeros(nbins, np.int64)
            for u in range(r * ntiles, t):
                before += local[u][1]
            assert (prefix[t] == before).all()
            lo, valid = tile * T, min(T, n - tile * T)
            tk = np.empty(valid, np.int64)
            tv = np.empty(valid, np.int64)
            tk[slot] = keys[r, lo:lo + valid]
            tv[slot] = (np.arange(lo, lo + valid) if vals is None
                        else vals[r, lo:lo + valid])
            goff = base[r, offs[p]:offs[p + 1]] + prefix[t] - dstart
            g = goff[(tk >> shift) & (nbins - 1)] + np.arange(valid)
            okeys[g], ovals[g] = tk, tv
        assert (okeys >= 0).all() and (ovals >= 0).all()
        if not last:
            # the intermediate: one 64-bit word a key, key low, index high
            mid = (okeys & 0xffffffff) | (ovals << 32)
            okeys, ovals = mid & 0xffffffff, mid >> 32
        keys, vals = okeys.reshape(R, n), ovals.reshape(R, n)
    # k_sort_tail: a block a row's span of TAIL_SPAN chunks, sign items
    # (column, chunk); a key and the next one in another bucket write the
    # boundaries between them, the first and the last key the ends; a run
    # longer than TAIL_RUN goes to the block's list
    nb = n // C
    sign = np.full(C * R * nb, -1, np.int64)
    for r in range(R):
        for k0 in range(0, nb, TAIL_SPAN):
            T = min(TAIL_SPAN, nb - k0)
            q = np.arange(T * C)
            col, t = q // T, q % T
            sign[(col * R + r) * nb + k0 + t] = keys[r, (k0 + t) * C + col] & 1
    assert (sign >= 0).all()
    M = 1 << (c - 1)
    cum = np.zeros((R, M + 1), np.int64)
    writes = np.zeros((R, M + 1), np.int64)
    b = np.clip(keys >> 1, 0, M + 1)
    for r in range(R):
        nxt = np.append(b[r, 1:], M + 1)
        runs = [(0, b[r, 0], 0, 0)] + [
            (b[r, p], nxt[p], p + 1, p) for p in np.nonzero(nxt != b[r])[0]]
        listed = Counter()
        for lo, hi, v, p in runs:
            cum[r, lo:hi] = v
            writes[r, lo:hi] += 1
            if hi - lo > TAIL_RUN:
                listed[p // (TAIL_SPAN * C)] += 1
        assert max(listed.values(), default=0) <= TAIL_GAPS
    assert (writes == 1).all()
    bsh = shape[:-1]
    return (keys.reshape(shape), vals.reshape(shape),
            sign.reshape((C,) + bsh + (n // C,)), cum.reshape(bsh + (M + 1,)))


def _check(digits, c, orders=("launch",)):
    want = _jax_bucket_order(digits, c)
    got = TM.digit_sort(torch.from_numpy(digits), c)
    assert [g.dtype for g in got] == [torch.int32] * 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), w)
    for order in orders:
        for m, w in zip(_model_sort(digits, c, order), want):
            assert np.array_equal(m, w)


@pytest.mark.parametrize("n", [256, 4096, 4352])
@pytest.mark.parametrize("c", CS)
def test_digit_sort_matches_jax(c, n):
    """Random digits of G = 2 windows x 4 rows, the wrapper (plain on the
    CPU) and the kernel's model against the JAX package."""
    _check(_digits(c * 1000 + n, (2, 4, n), c), c)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("c", CS)
def test_lookback_any_tile_order(c, order):
    """Rows of three whole tiles and a ragged one: the model's scatter
    passes give the JAX package's order whichever order their tiles
    publish and look back in (launch order, reversed, a seeded
    shuffle)."""
    n = 3 * TM.SORT_TILE + 256
    _check(_digits(c * 7 + 1, (2, 2, n), c), c, orders=(order,))


@pytest.mark.parametrize("kind", EDGES)
@pytest.mark.parametrize("c", CS)
def test_digit_sort_edge_tables(c, kind):
    """All keys 0 (padding); keys 0 and 1 only (key 1, a zero digit of a
    negated GLV half, belongs in bucket 0); every key 2^(c+1) - 1 (in no
    bucket); one row of 256; descending keys; one value in every tile
    (one status word's digit a tile), in launch and reversed order."""
    _check(_edge(kind, c), c, orders=("launch", "reversed"))


def test_keys_zero_and_one_fall_in_bucket_zero():
    d = np.array([[1, 0, 1, 2, 0, 3] * 64 + [1] * 640], np.int64)
    keys, perm, sign, cum = TM.digit_sort(torch.from_numpy(d), 4)
    assert int(cum[0, 0]) == int((d <= 1).sum())
    assert np.array_equal(keys.numpy()[0, :int(cum[0, 0])] & 1,
                          np.sort(d[0][d[0] <= 1]) & 1)
    assert np.array_equal(perm.numpy()[0], np.argsort(d[0], kind="stable"))


@pytest.mark.parametrize("c", CS)
def test_sort_plan(c):
    """The launch plan: bit ranges cover the c + 1 key bits low first in
    passes of at most SORT_MAX_BITS (one pass up to c = 9, two from
    c = 10), tiles of SORT_TILE keys, the counting pass's chunks, a status
    word a (row, tile, digit) of every pass, the workspace the wrapper
    allocates, and the traffic: 48 B a key with two passes, 32 with one,
    and the workspace's words."""
    want = {4: ((0, 5),), 8: ((0, 9),), 9: ((0, 10),),
            13: ((0, 7), (7, 7)), 16: ((0, 9), (9, 8))}[c]
    n, rows = 1 << 23, 8
    plan = TM.sort_plan(c, n, rows)
    assert plan.passes == want
    assert plan.tile == TM.SORT_TILE == 8192
    assert plan.tiles == n // TM.SORT_TILE
    assert plan.chunks == n // TM.COUNT_CHUNK
    bins = sum(1 << b for _, b in want)
    assert plan.bins == bins
    assert plan.status_words == rows * plan.tiles * bins
    assert plan.work_words == (TM.SORT_CTR_WORDS + plan.status_words
                               + rows * (plan.chunks + 1) * bins)
    two = len(want) > 1
    assert plan.workspace_bytes == (8 * rows * n if two else 0) \
        + 4 * plan.work_words
    keys = rows * n
    per_key = 48 if two else 32
    M = 1 << (c - 1)
    assert plan.traffic_bytes == per_key * keys + 4 * rows * (M + 1) \
        + 16 * plan.status_words + 8 * rows * (plan.chunks + 1) * bins
    assert plan.traffic_bytes < (per_key + 3) * keys
    assert TM.sort_plan(c, 4352, 3).tiles == 1
    assert TM.sort_plan(c, 3 * TM.SORT_TILE + 256, 3).tiles == 4


def test_sort_plan_every_c():
    for c in range(1, 17):
        plan = TM.sort_plan(c, 256, 1)
        passes = plan.passes
        assert [s for s, _ in passes] == [sum(b for _, b in passes[:i])
                                          for i in range(len(passes))]
        assert sum(b for _, b in passes) == c + 1
        assert all(1 <= b <= TM.SORT_MAX_BITS for _, b in passes)
        assert len(passes) == (1 if c <= 9 else 2)
        assert plan.bins == sum(1 << b for _, b in passes) <= 1024
        assert (plan.tiles, plan.chunks) == (1, 1)
        assert plan.status_words == plan.bins
    with pytest.raises(ValueError, match="digit_sort"):
        TM.sort_plan(17, 256, 1)


def test_sort_plan_refuses_a_row_past_the_status_count():
    """A status word holds a 30-bit count: a row of 2^30 keys or more is
    refused (R * n < 2^31 allows up to 2^31 - 256)."""
    assert TM.sort_plan(16, (1 << 30) - 256, 1).tiles == 1 << 17
    with pytest.raises(ValueError, match="30-bit"):
        TM.sort_plan(16, 1 << 30, 1)


@pytest.mark.parametrize("case", ["key_too_big", "key_negative", "ragged_n",
                                  "short_n", "dtype", "c_range", "not_card",
                                  "row_past_status"])
def test_digit_sort_refuses(case):
    d = torch.zeros((2, 512), dtype=torch.int64)
    c = 8
    if case == "key_too_big":
        d[1, 7] = 1 << 9
    elif case == "key_negative":
        d[0, 0] = -1
    elif case == "ragged_n":
        d = torch.zeros((2, 500), dtype=torch.int64)
    elif case == "short_n":
        d = torch.zeros((2, 128), dtype=torch.int64)
    elif case == "dtype":
        d = d.to(torch.int32)
    elif case == "c_range":
        c = 0
    elif case == "not_card":
        d = d.to("meta")
    elif case == "row_past_status":
        d = torch.zeros((1, 1 << 30), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="digit_sort"):
        TM.digit_sort(d, c)


def test_a_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.resolve("cuda")
    if not any(os.path.exists(os.path.join(d, "nvcc")) for d in
               os.environ.get("PATH", "").split(os.pathsep)
               + ["/usr/local/cuda/bin"]):
        with pytest.raises(RuntimeError, match="nvcc"):
            D.lib("sort")


# -- gather_cols ---------------------------------------------------------------

def _table(seed, rows, n, leaves):
    """A JAX-layout packed affine table: `leaves` leaves of (8, rows, n)
    uint32 words; the port's (rows, n, leaves, 8) through convert.py."""
    rng = np.random.RandomState(seed)
    jt = [rng.randint(0, 1 << 32, size=(8, rows, n), dtype=np.uint64)
          .astype(np.uint32) for _ in range(leaves)]
    port = np.stack([convert._words_rows(a) for a in jt], axis=-2)
    return jt, torch.from_numpy(port.view(np.int32))


def _model_gather(pts, perm):
    """csrc/gather.cu rs_gather_cols: blocks of one row r and a span of
    chunks, items (column, chunk, piece) of 16 bytes."""
    bsh, n, A = tuple(pts.shape[:-3]), pts.shape[-3], pts.shape[-2]
    B = int(np.prod(bsh)) if bsh else 1
    P = 2 * A
    table = pts.numpy().reshape(B, n * P, 4)
    pm = perm.numpy().reshape(-1, n)
    R, nb, span = pm.shape[0], n // C, 8
    out = np.zeros((C * R * nb * P, 4), np.int32)
    written = np.zeros(C * R * nb * P, np.int64)
    for r in range(R):
        for k0 in range(0, nb, span):
            T = min(span, nb - k0)
            idx = pm[r, k0 * C:(k0 + T) * C]
            q = np.arange(C * T * P)
            col, rem = q // (T * P), q % (T * P)
            tt, piece = rem // P, rem % P
            src = idx[tt * C + col].astype(np.int64) * P + piece
            dst = ((col * R + r) * nb + k0) * P + rem
            out[dst] = table[r % B][src]
            written[dst] += 1
    assert (written == 1).all()
    return out.reshape((C, perm.shape[0]) + bsh
                                        + (nb, A, 8))


@pytest.mark.parametrize("n", [256, 4096, 2560])
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_gather_cols_matches_jax(curve, n):
    """The sorted points of G = 2 windows x B rows (4 on G1, 1 on G2) in
    the column layout: the port's gather, the kernel's model and the JAX
    package's _gather_last of the same table by the same permutation."""
    rows, leaves = (4, 2) if curve == "g1" else (1, 4)
    jt, pts = _table(n + rows, rows, n, leaves)
    rng = np.random.RandomState(n)
    perm = np.stack([np.stack([rng.permutation(n) if g == 0 else
                               np.sort(rng.randint(0, n, size=n))
                               for _ in range(rows)]) for g in range(2)])
    perm = perm.astype(np.int32)
    got = TM.gather_cols(pts, torch.from_numpy(perm))
    want = [np.asarray(JM._gather_last(jnp.asarray(a), jnp.asarray(perm), 1))
            for a in jt]                           # (8, G, rows, n) each
    want = np.stack([convert._words_rows(a) for a in want], axis=-2)
    want = np.moveaxis(want.reshape((2, rows, n // C, C, leaves, 8)), 3, 0)
    assert got.shape == want.shape and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(_model_gather(pts, torch.from_numpy(perm)),
                          got.numpy())


def test_gather_cols_slice_view():
    """A slice of the table along n (as the segmented MSM cuts it): the
    plain version on the view equals it on a copy."""
    _, pts = _table(9, 4, 1024, 2)
    view = pts[:, 512:]
    perm = torch.from_numpy(np.stack([[np.random.RandomState(b).permutation(
        512) for b in range(4)]] * 2).astype(np.int32))
    assert torch.equal(TM.gather_cols(view, perm),
                       TM.gather_cols(view.contiguous(), perm))


@pytest.mark.parametrize("case", ["perm_rows", "perm_n", "ragged_n",
                                  "pts_tail", "devices"])
def test_gather_cols_refuses(case):
    pts = torch.zeros((4, 512, 2, 8), dtype=torch.int32)
    perm = torch.zeros((2, 4, 512), dtype=torch.int32)
    if case == "perm_rows":
        perm = perm[:, :3]
    elif case == "perm_n":
        perm = perm[..., :256]
    elif case == "ragged_n":
        pts, perm = pts[:, :500], perm[..., :500]
    elif case == "pts_tail":
        pts = torch.zeros((4, 512, 2, 4), dtype=torch.int32)
    elif case == "devices":
        perm = perm.to("meta")
    with pytest.raises(ValueError, match="gather_cols"):
        TM.gather_cols(pts, perm)


def test_window_group_calls_each_wrapper_once(monkeypatch):
    """msm's window groups order their buckets through digit_sort and
    gather_cols, once each a group, and look the boundaries up by
    dma_gather (twice a group); the window totals equal the msm's own."""
    calls = {"digit_sort": 0, "gather_cols": 0, "dma_gather": 0}
    for mod, name in ((TM, "digit_sort"), (TM, "gather_cols"),
                      (TFU, "dma_gather")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    rng = np.random.RandomState(4)
    n = 256
    pts = torch.from_numpy(rng.randint(0, 1 << 16, size=(1, n, 2, 8))
                           .astype(np.int32))
    pts[..., 7] = 0
    sc = torch.from_numpy(rng.randint(0, 1 << 31, size=(1, n, 8))
                          .astype(np.int32))
    sc[..., 7] = 0
    out = TM.msm(G1P, pts, sc, 8, window_group=8)
    assert out.shape == (16, 1, 3, 8)
    assert calls == {"digit_sort": 2, "gather_cols": 2, "dma_gather": 4}
