"""The CUDA kernels of rapidsnark_tpu_torch against their plain
PyTorch versions, on the card (marker `cuda`; each test skips when no
card is present). This file imports no JAX, so it runs on a machine
without it:

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels.py

Inputs are random canonical field elements from numpy seeds, with
(0,0) infinity columns and random signs for the scan. Tolerance: exact
words (REDC outputs are unique whatever the limb width; the G1 kernels
run the plain relaxed law's op sequence, and every value of the G2 law
is canonical, whatever the order of its products), except where the adds
run in another order than the plain version's: prefix_totals and the
MSM's window totals are compared as points (projective cross products,
G1 mod p)."""

import numpy as np
import pytest
import torch

from rapidsnark_tpu_torch.ops import fused as TFU
from rapidsnark_tpu_torch.ops.curve import G1P, G2P, G2P_ISO
from rapidsnark_tpu_torch.ref.field import P, R_FR

CURVES = {"G1P": (G1P, 3), "G2P_ISO": (G2P_ISO, 6)}
MIXED_CURVES = {"G1P": (G1P, 3), "G2P": (G2P, 6)}


def _dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fe(mod, shape, seed, dev):
    """Random canonical elements as packed int32 words (*shape, 8)."""
    rs = np.random.RandomState(seed)
    w = rs.randint(0, 1 << 32, size=tuple(shape) + (8,), dtype=np.uint64)
    w[..., 7] %= mod >> 224          # top word below the modulus's
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


# lane counts that divide no block or thread split of the adders
RAGGED = [1, 31, 33, 1000, 4097]


def _same_points(curve, a, b):
    """Projective points a, b (..., L, 8) are the same points: X1 Z2 =
    X2 Z1, Y1 Z2 = Y2 Z1 and Z1 = 0 exactly where Z2 = 0 (products of
    the plain field ops, canonical from relaxed G1 words too)."""
    from rapidsnark_tpu_torch.ops.curve import pack_point, unpack_point
    f = curve.f
    (x1, y1, z1), (x2, y2, z2) = unpack_point(curve, a), unpack_point(curve, b)
    one = f.one_mont(tuple(a.shape[:-2]), a.device)

    def words(u, v):
        return pack_point((f.mul(u, v),))

    def zero(z):                    # z times 1: canonical words
        return (words(z, one) == 0).flatten(-2).all(-1)

    return (torch.equal(words(x1, z2), words(x2, z1))
            and torch.equal(words(y1, z2), words(y2, z1))
            and torch.equal(zero(z1), zero(z2)))


def _one_words(dev):
    """1 in Montgomery form as 8 packed words."""
    return torch.tensor(np.array(
        [(((1 << 256) % P) >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
        dtype=np.uint32).view(np.int32), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("n", RAGGED)
def test_add_kernel_matches_plain(curve, n):
    """Random points, and lanes where q = p, q = -p, p at infinity and q
    at infinity ((0, 1, 0))."""
    dev = _dev()
    c, L = CURVES[curve]
    f = L // 3                              # words of one coordinate / 8
    p, q = _fe(P, (n, L), 1, dev), _fe(P, (n, L), 2, dev)
    q[2::5] = p[2::5]                                  # q = p
    neg = slice(3, None, 5)
    q[neg] = p[neg]
    from rapidsnark_tpu_torch.ops import field as FF
    q[neg, f:2 * f] = FF.pack(FF.FQ.neg(FF.unpack(p[neg, f:2 * f])))
    for t, lanes in ((p, slice(4, None, 7)), (q, slice(5, None, 7))):
        t[lanes] = 0
        t[lanes, f] = _one_words(dev)                  # (0, 1, 0)
    got = TFU.add(c, p, q)
    want = TFU.add_plain(c, p, q)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("K", [1, 2, 3, 256])
@pytest.mark.parametrize("n", RAGGED)
def test_scan_kernel_matches_plain(curve, K, n):
    """(0,0) entries in some lanes, a whole (0,0) column, signs set."""
    dev = _dev()
    c, L = CURVES[curve]
    A = L - L // 3
    acc = _fe(P, (n, L), 3, dev)
    cols = _fe(P, (K, n, A), 4, dev)
    cols[:, ::7] = 0                                   # infinity lanes
    if K > 2:
        cols[K // 2] = 0                               # an empty column
    rs = np.random.RandomState(K)
    sign = torch.from_numpy(rs.randint(0, 2, size=(K, n))
                            .astype(np.int32)).to(dev)
    got = TFU.scan_cols_packed(c, acc, cols, sign)
    want = TFU.scan_cols_plain(c, acc, cols, sign)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dif", [False, True])
def test_butterfly_kernel_matches_plain(dif):
    dev = _dev()
    lo, hi, tw = (_fe(R_FR, (3, 64), s, dev) for s in (5, 6, 7))
    got = TFU.ntt_butterfly(lo, hi, tw, dif)
    want = TFU.ntt_butterfly_plain(lo, hi, tw, dif)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("power,lo_bit,nbits,dif,pre", [
    (14, 0, 10, False, True), (14, 0, 10, True, False),
    (14, 10, 4, False, False), (14, 10, 4, True, False),
    (12, 10, 2, True, False), (12, 0, 10, False, False)])
def test_fused_pass_kernel_matches_plain(power, lo_bit, nbits, dif, pre):
    dev = _dev()
    x = _fe(R_FR, (2, 1 << power), 8, dev)
    tw = _fe(R_FR, (1 << (power - 1),), 9, dev)
    pm = _fe(R_FR, (1 << power,), 10, dev) if pre else None
    got = TFU.ntt_fused_pass(x, tw, lo_bit, nbits, dif, pm)
    want = TFU.ntt_fused_pass_plain(x, tw, lo_bit, nbits, dif, pm)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["packed", "limbs"])
@pytest.mark.parametrize("curve", sorted(MIXED_CURVES))
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_add_mixed_kernels_match_plain(curve, form, n):
    """Random canonical operands with (0,0) lanes, and lanes where the
    affine operand is +-(the projective one, z = 1). Odd lane counts
    leave a G2 pair's partner, or half a warp, past the end."""
    dev = _dev()
    c, L = MIXED_CURVES[curve]
    A = L - L // 3
    p, q = _fe(P, (n, L), 12, dev), _fe(P, (n, A), 13, dev)
    q[::7] = 0                                         # infinity lanes
    p[2::5, A:] = 0
    p[2::5, A] = _one_words(dev)                       # z = 1
    p[2::5, :A] = q[2::5]                              # q = p (doubling)
    if form == "limbs":
        qq = q.to(torch.int64) & 0xFFFFFFFF
        ql = torch.stack([qq & 0xFFFF, qq >> 16], dim=-1).reshape(
            n, A, 16).to(torch.int32).contiguous()
        got = TFU.add_mixed(c, p, ql)
        want = TFU.add_mixed_plain(c, p, ql)
    else:
        got = TFU.add_mixed_packed(c, p, q)
        want = TFU.add_mixed_packed_plain(c, p, q)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _edge_fq2(shape, dev, shift=0):
    """G2 coordinates (*shape, 8 words) whose Fq2 values are (p - 1, 0),
    (0, p - 1) or (p - 1, p - 1), in turns that differ from lane to lane:
    the largest component, and a partner component of 0, which the
    two-thread product negates."""
    pm1 = np.array([((P - 1) >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                   dtype=np.uint32)
    pats = [(1, 0), (0, 1), (1, 1)]
    w = np.zeros(tuple(shape) + (8,), dtype=np.uint32)
    flat = w.reshape(-1, 2, 8)
    for j in range(flat.shape[0]):
        for c in (0, 1):
            if pats[(j + j // 3 + shift) % 3][c]:
                flat[j, c] = pm1
    return torch.from_numpy(w.view(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "scan", "add_mixed"])
def test_g2_kernels_on_edge_components_match_plain(op):
    """The G2 adders (`add` and the scan on the iso-twist, the strict
    `add_mixed_packed` on the zkey's twist) on coordinates of p - 1 and
    0 components, 33 lanes; the scan over 4 columns with signs set."""
    dev = _dev()
    n, K = 33, 4
    p = _edge_fq2((n, 6), dev)
    if op == "add":
        q = _edge_fq2((n, 6), dev, shift=1)
        got = TFU.add(G2P_ISO, p, q)
        want = TFU.add_plain(G2P_ISO, p, q)
    elif op == "scan":
        cols = _edge_fq2((K, n, 4), dev)
        sign = torch.from_numpy(np.arange(K * n).reshape(K, n) % 2
                                ).to(torch.int32).to(dev)
        got = TFU.scan_cols_packed(G2P_ISO, p, cols, sign)
        want = TFU.scan_cols_plain(G2P_ISO, p, cols, sign)
    else:
        q = _edge_fq2((n, 4), dev, shift=2)
        got = TFU.add_mixed_packed(G2P, p, q)
        want = TFU.add_mixed_packed_plain(G2P, p, q)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dif", [False, True])
@pytest.mark.parametrize("power,batch", [(7, 1), (7, 3), (12, 2), (14, 3)])
def test_tail_kernel_matches_plain_and_fused_pass(power, batch, dif):
    dev = _dev()
    x = _fe(R_FR, (batch, 1 << power), 14, dev)
    tw = _fe(R_FR, (1 << (power - 1),), 15, dev)
    got = TFU.ntt_tail(x, tw, dif)
    want = TFU.ntt_tail_plain(x, tw, dif)
    same = TFU.ntt_fused_pass(x, tw, 0, 7, dif)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, same)


@pytest.mark.cuda
def test_segmented_msm_on_card_matches_cpu():
    """msm(segment=, row_slice=) through the kernels on the card gives
    the points of the plain path on the CPU (the chunk totals' prefix
    adds in another order there), with one scan launch per slice."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import msm as TM
    n, c, G = 512, 8, 16
    pts = _fe(P, (2, n, 2), 16, "cpu")
    pts[:, ::9] = 0                                    # infinity entries
    stack = _fe(1 << 253, (4, n), 17, "cpu")
    want = TM.msm(G1P, pts, stack, c, G, segment=256, row_slice=(1, 2))
    D.reset_counts()
    got = TM.msm(G1P, pts.to(dev), stack.to(dev), c, G, segment=256,
                 row_slice=(1, 2))
    torch.cuda.synchronize()
    assert D.counts["scan_cols_packed"] == 4
    assert _same_points(G1P, got.cpu(), want)


def _gather_case(logn, R, repeats, dev):
    rs = np.random.RandomState(logn + R)
    n = 1 << logn
    table = torch.from_numpy(rs.randint(0, 2**31, size=(n, R),
                                        dtype=np.int64).astype(np.int32))
    idx = (rs.randint(0, n // 8, size=n) if repeats
           else rs.permutation(n)).astype(np.int32)
    return table.to(dev), torch.from_numpy(idx).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("repeats", [False, True])
@pytest.mark.parametrize("logn,R,blk,nsem", [
    (18, 16, 512, 16), (21, 16, 512, 16), (21, 32, 512, 16),
    (18, 16, 256, 4), (12, 4, 64, 64), (12, 8, 4096, 32)])
def test_dma_gather_kernel_matches_plain(logn, R, blk, nsem, repeats):
    """A permutation and an index vector that repeats rows, at the
    tool's default shape, the 2^20 prove's G1 and G2 row shapes, and
    other (blk, nsem), one of them past 48 KB of staging."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    table, idx = _gather_case(logn, R, repeats, dev)
    D.reset_counts()
    got = TFU.dma_gather(table, idx, blk=blk, nsem=nsem)
    want = TFU.dma_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert D.counts["dma_gather"] == 1
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
def test_dma_gather_refuses_on_card():
    dev = _dev()
    table, idx = _gather_case(12, 16, False, dev)
    for bad in ((table, idx[:4000], {}),                     # ragged m
                (table, idx, {"blk": 512, "nsem": 24}),
                (table.t().contiguous().t(), idx, {}),       # strided
                (table, idx.cpu(), {})):
        with pytest.raises(ValueError, match="dma_gather"):
            TFU.dma_gather(bad[0], bad[1], **bad[2])


@pytest.mark.cuda
@pytest.mark.parametrize("g2", [False, True])
def test_combine_windows_on_card_matches_host_combine(g2):
    """_combine_windows through the add kernel on the card against the
    host's Horner combine of the same points (z = 1, one infinity),
    equal after affine normalisation; (nwin - 1)(c + 1) add launches."""
    dev = _dev()
    import random
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import msm as TM
    from rapidsnark_tpu_torch.ref import curve as refc
    from rapidsnark_tpu_torch.ref.field import FQ_CTX, R_FR as R
    from rapidsnark_tpu_torch.utils import points as PT
    from rapidsnark_tpu_torch.utils.hostcurve import G1H, G2H
    nwin, c = 10, 13
    rng = random.Random(7)
    grp, gen = (refc.G2, refc.G2_GEN) if g2 else (refc.G1, refc.G1_GEN)
    pts = [grp.mul(gen, rng.randrange(1, R)) for _ in range(nwin)]
    pts[3] = None
    conv = PT.g2_affine_to_mont_limbs if g2 else PT.g1_affine_to_mont_limbs
    arr = np.stack([conv(p) for p in pts]).astype(np.uint32)   # (W, A, 16)
    words = arr[..., 0::2] | (arr[..., 1::2] << 16)
    one = np.array([(((1 << 256) % P) >> (32 * i)) & 0xFFFFFFFF
                    for i in range(8)], np.uint32)
    z = np.zeros((nwin, 2 if g2 else 1, 8), np.uint32)
    z[:, 0] = one
    z[3] = 0
    words[3, 2 if g2 else 1] = one                             # (0, 1, 0)
    wpts = torch.from_numpy(np.concatenate([words, z], axis=1)[:, None]
                            .view(np.int32)).to(dev)
    curve, H = (G2P, G2H) if g2 else (G1P, G1H)
    D.reset_counts()
    tot = TM._combine_windows(curve, wpts, nwin, c)
    torch.cuda.synchronize()
    assert D.counts["add"] == (nwin - 1) * (c + 1)
    host = H.to_affine(H.combine_windows([H.from_affine(p) for p in pts], c))
    w = tot.cpu().numpy().view(np.uint32)[0]
    ints = [FQ_CTX.from_mont(sum(int(v) << (32 * i) for i, v in enumerate(k)))
            for k in w]
    got = H.to_affine(((ints[0], ints[1]), (ints[2], ints[3]),
                       (ints[4], ints[5])) if g2 else tuple(ints))
    assert grp.eq(got, host)


@pytest.mark.cuda
def test_wrappers_count_launches():
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    D.reset_counts()
    p = _fe(P, (4, 3), 11, dev)
    TFU.add(G1P, p, p)
    TFU.add_plain(G1P, p, p)
    assert D.counts["add"] == 1


@pytest.mark.cuda
def test_ntt_plan_on_card_equals_cpu_plan():
    """NTTPlan's device-built tables at 2^20: the card's words are the
    CPU's."""
    dev = _dev()
    from rapidsnark_tpu_torch.ops.ntt import NTTPlan
    card, cpu = NTTPlan(20, dev).tensors(), NTTPlan(20, "cpu").tensors()
    assert sorted(card) == sorted(cpu)
    for k, v in cpu.items():
        assert card[k].device.type == "cuda"
        assert torch.equal(card[k].cpu(), v), k


@pytest.mark.cuda
def test_fast_setup_on_card_writes_the_cpu_bytes(tmp_path):
    """fixtures.fast_setup at 2^10 (scalars, ladders on the kernels) on
    the card writes the zkey the CPU path writes."""
    dev = _dev()
    from rapidsnark_tpu_torch import fixtures
    from rapidsnark_tpu_torch.io.zkey import write_zkey
    out = {}
    for where in (dev, "cpu"):
        zk = fixtures.fast_setup(fixtures.sqchain_coo((1 << 10) - 2),
                                 seed="bench-10", device=where)
        path = tmp_path / f"{torch.device(where).type}.zkey"
        write_zkey(str(path), zk)
        out[where] = path.read_bytes()
    assert out[dev] == out["cpu"]


def _slot_case(rows, K, nvars, seed, dev):
    """A witness (nvars, 8) and K slot-major slots a row with random
    indices and values, one slot in five empty (value 0, index 0)."""
    rs = np.random.RandomState(seed)
    wit = _fe(R_FR, (nvars,), seed + 1, dev)
    cs = torch.from_numpy(rs.randint(0, nvars, size=(K, rows))
                          .astype(np.int32)).to(dev)
    cv = _fe(R_FR, (K, rows), seed + 2, dev)
    cs.view(-1)[::5] = 0
    cv.view(-1, 8)[::5] = 0
    return wit, cs, cv


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("rows", [1, 1000, 4097])
def test_slot_acc_kernel_matches_plain(K, rows):
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import front as FRONT
    wit, cs, cv = _slot_case(rows, K, 700, 20 + K, dev)
    D.reset_counts()
    got = FRONT.fr_slot_acc(wit, cs, cv)
    want = FRONT.fr_slot_acc_plain(wit, cs, cv)
    torch.cuda.synchronize()
    assert D.counts["fr_slot_acc"] == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("terms", [100, 1024, 3 * 1024 + 5, (1 << 15) + 700])
def test_slot_acc_kernel_spill_rows_match_plain(terms):
    """Rows with spilled records: one of `terms` terms (one chunk,
    exactly one, several and a remainder), a few of one or three, the
    last row among them; the records come unsorted, as binning leaves
    them."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import front as FRONT
    rows, K = 1000, 2
    wit, cs, cv = _slot_case(rows, K, 700, 30, dev)
    rs = np.random.RandomState(31)
    tgt = np.concatenate([np.full(terms, 5), [37, 37, 38, 999, 999, 999]])
    rs.shuffle(tgt)
    ls = torch.from_numpy(rs.randint(0, 700, size=tgt.size)).to(dev)
    lv = _fe(R_FR, (tgt.size,), 32, dev)
    spill, _ = FRONT.make_spill(ls, lv, torch.from_numpy(tgt).to(dev), rows)
    D.reset_counts()
    got = FRONT.fr_slot_acc(wit, cs, cv, spill)
    want = FRONT.fr_slot_acc_plain(wit, cs, cv, spill)
    torch.cuda.synchronize()
    # the slots, the chunks, and the rows of several chunks: each launch
    # counted
    assert D.counts["fr_slot_acc"] == 2 + (terms > FRONT.SPILL_CHUNK)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("power", [1, 2, 7, 10, 11])
def test_small_transforms_on_card_match_per_layer_plain(power, monkeypatch):
    """The default dispatch below 2^12 (fused passes: one a direction up
    to 2^10) against the per-layer path's plain versions on the CPU, a
    stack of 3 with the coset pre-multiply."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import ntt as TN
    monkeypatch.delenv("RSTPU_NTT_FUSE", raising=False)
    n = 1 << power
    tables = TN.NTTPlan(power, "cpu").tensors()
    x = _fe(R_FR, (3, n), 50 + power, "cpu")
    D.reset_counts()
    got = TN.to_odd_coset(x.to(dev), {k: v.to(dev)
                                      for k, v in tables.items()})
    torch.cuda.synchronize()
    assert D.counts["ntt_fused_pass"] == 2 * (1 + (power > 10))
    assert D.counts["ntt_butterfly"] == 0
    monkeypatch.setenv("RSTPU_NTT_FUSE", "0")
    want = TN.to_odd_coset(x, tables)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("op,ashape,bshape", [
    ("mul", (1000,), (1000,)), ("mul", (3, 1000), (1000,)),
    ("mul", (3, 100), ()), ("sub", (4097,), (4097,)),
    ("h", (4097,), (4097,))])
def test_pointwise_kernel_matches_plain(op, ashape, bshape):
    """Same shapes, a row broadcast over a stack, one element over all."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import front as FRONT
    a, b = _fe(R_FR, ashape, 40, dev), _fe(R_FR, bshape, 41, dev)
    c = _fe(R_FR, ashape, 42, dev) if op == "h" else None
    D.reset_counts()
    got = FRONT.fr_pointwise(op, a, b, c)
    want = FRONT.fr_pointwise_plain(op, a, b, c)
    torch.cuda.synchronize()
    assert D.counts["fr_pointwise"] == 1
    assert torch.equal(got, want)


# -- the MSM's preparation kernels (csrc/msm.cu) ----------------------------

def _prep_scalars(rows, n, seed, dev):
    """(rows, n, 8) scalars < r: the edge table of both groups' GLV
    constants first, then random ones."""
    from rapidsnark_tpu_torch.ops import glv as TG
    sc = _fe(R_FR, (rows, n), seed, "cpu")
    edge = TG.edge_scalars(TG.G1_PARAMS) + TG.edge_scalars(TG.G2_PARAMS)
    words = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                      for v in edge], dtype=np.uint32).view(np.int32)
    flat = sc.view(-1, 8)
    flat[:len(edge)] = torch.from_numpy(words)
    return sc.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["k1", "k2", "both", "no_glv"])
@pytest.mark.parametrize("c", [4, 8, 11, 13, 16])
@pytest.mark.parametrize("g2", [False, True])
def test_glv_digits_kernel_matches_plain(g2, c, mode):
    """Every window's encoded digits of a 2^24 slice's scalars (4 rows of
    2^19 for G1, 1 for G2; the edge table in front), and of a strided
    slice of them as the segmented MSM cuts it; the stable sort of a
    window group gives the plain digits' permutation."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import glv as TG
    from rapidsnark_tpu_torch.ops import msm as TM
    rows, n = (1, 1 << 19) if g2 else (4, 1 << 19)
    sc = _prep_scalars(rows, n, 60 + c, dev)
    params = None if mode == "no_glv" else (
        TG.G2_PARAMS if g2 else TG.G1_PARAMS)
    half = {"k1": 0, "k2": 1}.get(mode)
    nwin = -(-(256 if params is None else 128) // c)
    for view in (sc, sc[:, 1000:1000 + (1 << 16)]):
        D.reset_counts()
        got = TM.glv_digits(view, c, 0, nwin, params, half)
        want = TM.glv_digits_plain(view, c, 0, nwin, params, half)
        torch.cuda.synchronize()
        assert D.counts["glv_digits"] == 1
        assert got.dtype == torch.int64 and torch.equal(got, want)
    w0, G = 1, min(5, nwin - 1)                # a window range alone
    assert torch.equal(TM.glv_digits(sc, c, w0, G, params, half),
                       TM.glv_digits_plain(sc, c, w0, G, params, half))
    grp = TM.glv_digits(sc, c, 0, min(5, nwin), params, half)
    _, perm = torch.sort(grp, dim=-1, stable=True)
    _, perm_plain = torch.sort(TM.glv_digits_plain(
        sc, c, 0, min(5, nwin), params, half), dim=-1, stable=True)
    assert torch.equal(perm, perm_plain)


def _prep_points(shape, L, seed, dev):
    """Canonical coordinates (*shape, L, 8) with (0, 0) rows and words 0,
    1 and p - 1 in front."""
    t = _fe(P, tuple(shape) + (L,), seed, "cpu")
    flat = t.view(-1, L, 8)
    flat[::7] = 0
    flat[1, :, 0] = 1
    flat[1, :, 1:] = 0
    pm1 = np.array([((P - 1) >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                   dtype=np.uint32).view(np.int32)
    flat[2] = torch.from_numpy(pm1)
    return t.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["phi_g1", "phi_g2", "iso_fwd", "iso_back",
                                  "neg_g1", "neg_g2", "rescale",
                                  "ragged_slice", "mixed_ext1", "mixed_ext2",
                                  "rows_past_grid"])
def test_fq_scale_kernel_matches_plain(case):
    """fq_scale through each caller at its 2^24 shapes: phi on a slice of
    the G1 (4 rows) and G2 table, the window totals to and from the
    iso-twist, the negation of a window group's bucket sums (a strided
    view; G1 coordinates up to 2p), the table rescale; and the layouts
    the kernel's block split has to get right: a slice whose rows end in
    a ragged block, specs mixing copies, negations and products, and
    more rows than the grid's y axis holds."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import msm as TM
    seg = 1 << 19
    if case in ("ragged_slice", "mixed_ext1", "mixed_ext2",
                "rows_past_grid"):
        beta = TM.GLV.params_for(G1P).beta_mont
        t, spec, ext = {
            "ragged_slice": lambda: (
                _prep_points((3, 2 * 1013), 4, 78, dev)[:, 1013:],
                (beta, 5, None, "neg"), 1),
            "mixed_ext1": lambda: (
                _prep_points((7, 333), 6, 79, dev),
                (beta, "neg", None, "neg_rx", 12345, None), 1),
            "mixed_ext2": lambda: (
                _prep_points((5, 77), 6, 80, dev),
                ("neg", (beta, 77), None), 2),
            "rows_past_grid": lambda: (
                _prep_points((70000, 2), 2, 81, dev)[:, :1],
                ("neg", beta), 1),
        }[case]()
        got = TM.fq_scale(t, spec, ext)
        torch.cuda.synchronize()
        assert torch.equal(got, TM.fq_scale_plain(t, spec, ext))
        return
    if case in ("phi_g1", "phi_g2"):
        g2 = case == "phi_g2"
        table = _prep_points((1 if g2 else 4, 2 * seg), 4 if g2 else 2, 70,
                             dev)
        curve = G2P_ISO if g2 else G1P
        D.reset_counts()
        got = TM._table_slice(curve, table, 3 * seg, seg)
        torch.cuda.synchronize()
        assert D.counts["fq_scale"] == 1
        beta = TM.GLV.params_for(curve).beta_mont
        nx = 2 if g2 else 1
        want = TM.fq_scale_plain(table[:, seg:], (beta,) * nx + (None,) * nx)
        assert torch.equal(got, want)
        return
    if case in ("iso_fwd", "iso_back"):
        pts = _prep_points((26, 1), 6, 71, dev)
        got = TM._iso_scale(G2P, pts, back=case == "iso_back")
        iso = G2P_ISO.iso
        k = ("w2i", "w3i") if case == "iso_back" else ("w2", "w3")
        want = TM.fq_scale_plain(pts, (iso[k[0]], iso[k[1]], None), ext=2)
    elif case in ("neg_g1", "neg_g2"):
        g2 = case == "neg_g2"
        L, M = (6, 4096) if g2 else (3, 4096)
        A = _prep_points((5, 1 if g2 else 4, M + 1), L, 72, dev)
        if not g2:                          # relaxed coordinates up to 2p
            two_p = np.array([((2 * P) >> (32 * i)) & 0xFFFFFFFF
                              for i in range(8)], dtype=np.uint32)
            A[0, 0, 3, 1] = torch.from_numpy(two_p.view(np.int32)).to(dev)
        head = A[..., :M, :, :]
        got = TM.point_neg(G2P_ISO if g2 else G1P, head)
        want = TM.fq_scale_plain(head, (None, "neg" if g2 else "neg_rx",
                                        None), 2 if g2 else 1)
    else:
        table = _prep_points((1, 1 << 20), 4, 73, dev)
        got = TM.g2_rescale_packed(table)
        want = TM.fq_scale_plain(table, (G2P_ISO.iso["w2"],
                                         G2P_ISO.iso["w3"]), ext=2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_prep_kernels_refuse_on_card():
    """Views whose rows are not contiguous, and wrong types, raise."""
    dev = _dev()
    from rapidsnark_tpu_torch.ops import msm as TM
    from rapidsnark_tpu_torch.ops import glv as TG
    sc = _fe(R_FR, (4, 512), 74, dev)
    with pytest.raises(ValueError):
        TM.glv_digits(sc.transpose(0, 1), 13, 0, 10, TG.G1_PARAMS)
    with pytest.raises(ValueError):
        TM.glv_digits(sc.long(), 13, 0, 10, TG.G1_PARAMS)
    pts = _fe(P, (8, 2), 75, dev)
    with pytest.raises(ValueError):
        TM.fq_scale(pts[::2], (1, None))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 8, 9, 13, 16])
@pytest.mark.parametrize("shape,kind", [
    ((2, 4, 4096), "random"), ((1, 256), "random"), ((2, 4, 4352), "zeros"),
    ((2, 4, 4352), "top"), ((2, 4, 12544), "one value a tile"),
    ((2, 3, 5 * 8192 + 768), "random")])
def test_digit_sort_kernel_matches_plain(c, shape, kind):
    """Sorted keys, permutation, sign columns and boundaries, word for
    word, on random digits and edge tables (ragged tiles included; rows
    of several tiles, whose scatter blocks look back)."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import msm as TM
    rs = np.random.RandomState(c * 100 + shape[-1])
    top = 1 << (c + 1)
    if kind == "random":
        d = rs.randint(0, top, size=shape)
    elif kind == "zeros":
        d = np.zeros(shape)
    elif kind == "top":
        d = np.full(shape, top - 1)
    else:
        d = np.broadcast_to((np.arange(shape[-1]) // TM.SORT_TILE * 5 + 1)
                            % top, shape)
    d = torch.from_numpy(np.ascontiguousarray(d, dtype=np.int64)).to(dev)
    D.reset_counts()
    got = TM.digit_sort(d, c)
    want = TM.digit_sort_plain(d, c)
    torch.cuda.synchronize()
    assert D.counts["digit_sort"] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("A,rows,n,view", [
    (2, 4, 4096, False), (4, 1, 2560, False), (2, 4, 4096, True)])
def test_gather_cols_kernel_matches_plain(A, rows, n, view):
    """The column layout of G = 2 windows, on a contiguous table and on a
    slice view of one (ragged spans of chunks included)."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import msm as TM
    tab = _fe(P, (rows, 2 * n if view else n, A), 76, dev)
    pts = tab[:, n:] if view else tab
    rs = np.random.RandomState(n)
    perm = torch.from_numpy(np.stack([[rs.permutation(n) for _ in
                                       range(rows)] for _ in range(2)])
                            .astype(np.int32)).to(dev)
    D.reset_counts()
    got = TM.gather_cols(pts, perm)
    want = TM.gather_cols_plain(pts, perm)
    torch.cuda.synchronize()
    assert D.counts["gather_cols"] == 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="gather_cols"):
        TM.gather_cols(pts, perm.long())


@pytest.mark.cuda
@pytest.mark.parametrize("glv", [True, False])
def test_segmented_g2_msm_on_card_matches_cpu(glv):
    """The G2 MSM in slices on the card (digits, phi, negations and the
    iso-twist's scaling on the preparation kernels) gives the CPU's
    points; every slice launches glv_digits once."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import msm as TM
    n, c, G = 512, 8, 16 if glv else 32
    pts = _fe(P, (1, n, 4), 76, "cpu")
    pts[:, ::9] = 0
    sc = _fe(R_FR, (1, n), 77, "cpu")
    want = TM.msm(G2P, pts, sc, c, G, segment=256, glv=glv)
    D.reset_counts()
    got = TM.msm(G2P, pts.to(dev), sc.to(dev), c, G, segment=256, glv=glv)
    torch.cuda.synchronize()
    slices = 4 if glv else 2
    assert D.counts["glv_digits"] == slices
    assert D.counts["fq_scale"] == (2 if glv else 0) + slices + 1
    assert _same_points(G2P, got.cpu(), want)


@pytest.mark.cuda
def test_sharded_msm_and_dntt_on_one_rank_nccl(tmp_path):
    """On a one-rank NCCL group, msm_sharded gives msm's window totals and
    dntt gives ntt's outputs, word for word (one rank adds nothing across
    ranks; the G2 totals' map onto the iso-twist and back is exact on
    canonical words); NCCL with two ranks on this one card is refused."""
    dev = _dev()
    from rapidsnark_tpu_torch.ops import msm as TM, ntt as TN
    from rapidsnark_tpu_torch.parallel import multihost as MH, pmsm, pntt
    if torch.cuda.device_count() == 1:
        with pytest.raises(RuntimeError, match="one card a rank"):
            MH.initialize(num_processes=2, process_id=0, backend="nccl",
                          device="cuda",
                          init_method="file://" + str(tmp_path / "two"))
    MH.initialize(num_processes=1, process_id=0, backend="nccl",
                  device="cuda", init_method="file://" + str(tmp_path / "one"))
    try:
        mesh = MH.global_mesh("cuda")
        assert (mesh.size, mesh.backend) == (1, "nccl")
        n, c, G = 1024, 8, 16
        for curve, A, seed in ((G1P, 2, 31), (G2P, 4, 32)):
            pts = _fe(P, (2, n, A), seed, dev)
            pts[:, ::9] = 0                            # infinity entries
            sc = _fe(1 << 253, (2, n), seed + 10, dev)
            want = TM.msm(curve, pts, sc, c, G, segment=512)
            got = pmsm.msm_sharded(curve, pts, sc, c, mesh, G,
                                   combine=False, segment=512)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        power = 12
        x = _fe(R_FR, (3, 1 << power), 33, dev)
        plan = pntt.DNTTPlan(power, 1, dev)
        single = TN.NTTPlan(power, dev).tensors()
        for inverse in (False, True):
            got = pntt.dntt(x, plan.tensors(), plan, mesh, inverse=inverse)
            want = TN.ntt(x, single, inverse=inverse)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        assert mesh.stats["all_to_all_calls"] == 6
        assert mesh.stats["all_gather_calls"] == 2
    finally:
        MH.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["writeable", "mapped"])
def test_witness_ring_upload_equals_source(source, tmp_path):
    """Two witnesses of ~2.5 chunks each through one ring of pinned slots
    (utils/staging), back to back with no synchronisation between: a
    slot refilled before its last copy drained would change the first.
    Each equals its source word for word, from a writeable array and
    from a read-only mapped file (as a mapped .wtns payload is), and
    count.front.staged is the plan's chunk count a witness."""
    dev = _dev()
    from rapidsnark_tpu_torch.utils import staging as ST
    from rapidsnark_tpu_torch.utils.logger import TRACE, collect, get_logger
    rows = 5 * ST.CHUNK_BYTES // (2 * ST.ROW_BYTES) + 3
    rng = np.random.default_rng(41)
    words = []
    for i in range(2):
        w = rng.integers(0, 1 << 32, size=(rows, 8), dtype=np.uint32)
        if source == "mapped":
            path = tmp_path / f"w{i}.bin"
            w.tofile(path)
            w = np.memmap(path, dtype=np.uint32, mode="r", shape=(rows, 8))
            assert not w.flags.writeable
        words.append(w)
    nchunks = len(ST.chunk_plan(rows * ST.ROW_BYTES))
    assert nchunks == 3
    log = get_logger()
    level = log.level
    log.setLevel(TRACE)                       # spans, and counts, on
    ring, got, counted = ST.Ring(), [], []
    try:
        for w in words:
            sink = {}
            with collect(sink):
                got.append(ring.upload(w, dev))
            counted.append(sink.get("count.front.staged"))
    finally:
        log.setLevel(level)
    torch.cuda.synchronize()
    assert counted == [nchunks, nchunks]
    for g, w in zip(got, words):
        assert g.dtype == torch.int32 and tuple(g.shape) == (rows, 8)
        assert np.array_equal(g.cpu().numpy().view(np.uint32), w)
    ring.release()


def _lift_p(t):
    """Packed words (..., 8) of values below p, plus p: the same residue
    in the relaxed [p, 2p) range."""
    w = t.to(torch.int64) & 0xFFFFFFFF
    out, carry = [], 0
    for i in range(8):
        v = w[..., i] + ((P >> (32 * i)) & 0xFFFFFFFF) + carry
        out.append(v & 0xFFFFFFFF)
        carry = v >> 32
    v = torch.stack(out, dim=-1)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _curve_rows(g2, rows, nb, seed, dev):
    """(rows, nb, L, 8) projective points on the card, of G1 or of the G2
    iso-twist: 64 random multiples of the generator drawn at random, every
    coordinate times a random s (so z = s), every 7th point infinity; on
    G1 a third of the coordinates lifted by p (the relaxed range)."""
    import random
    from rapidsnark_tpu_torch.ops.curve import pack_point, unpack_point
    from rapidsnark_tpu_torch.ref.field import FQ_CTX
    from test_torch_prefix_totals import (G1_GEN, G1H, G2H_ISO, _iso_gen,
                                          _words)
    rng = random.Random(seed)
    curve, H, gen = ((G2P_ISO, G2H_ISO, _iso_gen()) if g2
                     else (G1P, G1H, G1_GEN))
    one = [FQ_CTX.to_mont(1)] + [0] * g2
    base = []
    for _ in range(64):
        x, y = H.to_affine(H.mul(H.from_affine(gen),
                                 rng.randrange(1, 1 << 20)))
        flat = [c for v in (x, y) for c in (v if g2 else (v,))]
        base.append([_words(FQ_CTX.to_mont(c)) for c in flat]
                    + [_words(c) for c in one])
    base = torch.from_numpy(np.array(base, np.uint32).view(np.int32))
    rs = np.random.RandomState(seed)
    pts = base[torch.from_numpy(rs.randint(0, 64, size=(rows, nb)))].to(dev)
    s = _fe(P, (rows, nb, 1 + g2), seed + 1, dev)
    sc = unpack_point(curve, s)[0]
    f = curve.f
    pts = pack_point(tuple(f.mul(c, sc) for c in unpack_point(curve, pts)))
    flat = pts.view(-1, pts.shape[-2], 8)
    flat[::7] = 0
    flat[::7, 2 if g2 else 1] = _one_words(dev)       # (0, 1, 0)
    if not g2:
        lift = torch.from_numpy(rs.rand(rows, nb, 3) < 1 / 3).to(dev)
        pts = torch.where(lift[..., None], _lift_p(pts), pts)
    return pts.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("g2,rows,nb", [
    (False, 16, 16384), (True, 4, 16384),     # the 2^24 plan's window group
    (False, 16, 20224), (True, 4, 20224),     # the wide 2^22 circuit's
    (False, 16, 1), (True, 4, 1), (False, 3, 1000), (True, 2, 513)])
def test_prefix_totals_kernel_matches_plain(g2, rows, nb):
    """The kernel's exclusive prefix of rows of chunk totals is the plain
    version's (on the card: the two-level Hillis-Steele prefix of `add`s)
    point for point: at the 2^24 plan's shapes (16 x 16,384 G1 and
    4 x 16,384 G2 totals), at nb = 80,896 / 4 (no power of two), at
    nb = 1 and on ragged rows; two launches a call and no `add`."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    curve = G2P_ISO if g2 else G1P
    tot = _curve_rows(g2, rows, nb, rows * nb + g2, dev)
    D.reset_counts()
    got = TFU.prefix_totals(curve, tot)
    assert D.counts["prefix_totals"] == 2 and D.counts["add"] == 0
    want = TFU.prefix_totals_plain(curve, tot)
    torch.cuda.synchronize()
    assert got.shape == tot.shape
    assert _same_points(curve, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("g2", [False, True])
def test_window_group_prefix_is_one_kernel_call(g2):
    """One ops/msm._window_group on the card takes its chunk totals'
    prefix from one prefix_totals call (two launches) and launches `add`
    for the buckets alone: _ps_at's add, the difference, the halving tree
    down to 64 lanes and the Hillis steps over them."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import msm as TM
    n, c, G = 1024, 8, 2
    curve, A = (G2P_ISO, 4) if g2 else (G1P, 2)
    pts = _fe(P, (n, A), 81, dev)
    rs = np.random.RandomState(82)
    digits = torch.from_numpy(rs.randint(0, 1 << (c + 1), size=(G, n))
                              .astype(np.int64)).to(dev)
    D.reset_counts()
    TM._window_group(curve, pts, digits, n, c)
    torch.cuda.synchronize()
    size, tree = 1 << (c - 1), 0
    while size > 64:
        size //= 2
        tree += 1
    assert D.counts["prefix_totals"] == 2
    assert D.counts["scan_cols_packed"] == 1
    assert D.counts["add"] == 2 + tree + (size - 1).bit_length()


@pytest.mark.cuda
def test_prove_2_20_unchanged_by_prefix_kernel(tmp_path, monkeypatch):
    """A generated 2^20 sqchain proved on the card for a fixed (r, s) gives
    the same proof and public signals with the chunk totals' prefix on
    its kernel as with the plain version in its place."""
    dev = _dev()
    from rapidsnark_tpu_torch import fixtures
    from rapidsnark_tpu_torch.io.wtns import read_wtns
    from rapidsnark_tpu_torch.io.zkey import read_zkey
    from rapidsnark_tpu_torch.prover import Prover
    zpath, wpath = fixtures.generate(20, str(tmp_path), device=dev)
    with read_zkey(zpath) as zk:
        prover = Prover(zk, device=dev)
        w = read_wtns(wpath).values
        r, s = 0x1234567, 0x89ABCDE
        proofs = []
        for prefix in (TFU.prefix_totals, TFU.prefix_totals_plain):
            monkeypatch.setattr(TFU, "prefix_totals", prefix)
            proof, pub = prover.prove(w, r=r, s=s)
            proofs.append((proof.a, proof.b, proof.c, list(pub)))
        prover.release()
    assert proofs[0] == proofs[1]
