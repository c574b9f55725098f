"""fq_scale's kernel (csrc/msm.cu k_fq_scale) modelled on the CPU.

The model runs the launch as rs_fq_scale sets it up (rows that lie back
to back merged into one, tiles of SCALE_WT = 32 points of one row) and
each tile as a warp of k_fq_scale runs it: the 16-byte chunks of the
tile's points copied into shared memory at (8A + 4) words a point (lane
c the c-th chunk), the plan's work items run one after the other with
lane l on point l (kind and component from the plan's packed 64-bit
code; copies are no items), with the kernel's word arithmetic on Python
ints, and the chunks stored. It is held against ops/msm.fq_scale_plain
on each caller's layout: the strided negation head, a slice view
[:, n:], ragged tails, ext 1 and 2, mixed copy / negation / product
specs, and 70,000 rows of one point. Each output word must be written
exactly once, only words of the view read, and a phase of 8 lanes read
8 distinct bank groups. Tolerance: exact words (canonical Montgomery
residues are unique; the negations are the plain version's p - a and
2p - a)."""

import numpy as np
import pytest
import torch

from rapidsnark_tpu_torch.ops import glv as TG
from rapidsnark_tpu_torch.ops import msm as TM
from rapidsnark_tpu_torch.ops.curve import G1P, G2P_ISO
from rapidsnark_tpu_torch.ref.field import P

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)

MASK = (1 << 256) - 1
RINV = pow(1 << 256, -1, P)
INT_MAX = (1 << 31) - 1
BETA1 = TG.params_for(G1P).beta_mont
BETA2 = TG.params_for(G2P_ISO).beta_mont
ISO = G2P_ISO.iso


def _words(vals):
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], dtype=np.uint32)


def _int(ws) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(ws))


def _points(shape, seed, edges=()):
    """Canonical words (*shape, 8), (0, 0) points every 7th entry, and
    `edges` (ints) in the first components."""
    rs = np.random.RandomState(seed)
    w = rs.randint(0, 1 << 32, size=tuple(shape) + (8,), dtype=np.uint64)
    w[..., 7] %= P >> 224
    w = w.astype(np.uint32)
    flat = w.reshape((-1,) + tuple(shape[-1:]) + (8,))
    flat[::7] = 0
    if edges:
        flat.reshape(-1, 8)[:len(edges)] = _words(edges)
    return torch.from_numpy(w.view(np.int32))


def _op(kind, a, b, ks):
    """The kernel's word arithmetic for one item: (first word, second
    word or None) from the component(s) a (and b for an Fq2 product)."""
    if kind == TM.SCALE_MUL:
        return a * ks[0] * RINV % P, None
    if kind == TM.SCALE_NEG:                  # f_sub(0, a)
        d = (0 - a) & MASK
        return ((d + P) & MASK if a > 0 else d), None
    if kind == TM.SCALE_NEG_RX:               # sub8(2p, a)
        return (2 * P - a) & MASK, None
    assert kind == TM.SCALE_MUL2
    m0 = a * ks[0] * RINV % P
    m1 = b * ks[1] * RINV % P
    tt = ((a + b) & MASK) * ks[2] * RINV % P
    return (m0 - m1) % P, (tt - m0 - m1) % P


def kernel_model(t: torch.Tensor, spec, ext: int):
    """fq_scale's output on t as the kernel computes it, and the storage
    words it read."""
    A = t.shape[-2]
    v = t if t.dim() >= 3 else t[None]
    rows, n, stride = TM._row_layout(v, (A, 8), "model")
    plan = TM._scale_plan(tuple(spec), ext)
    # rs_fq_scale
    if rows > 1 and stride == n * A * 8:
        n, rows = n * rows, 1
    T = TM.SCALE_WT
    S, CH = 8 * A + 4, 2 * A
    tpr = -(-n // T)
    assert n <= INT_MAX and rows * tpr <= INT_MAX
    assert plan.code < 1 << 64, "the items fit the kernel's 64-bit code"
    assert len({(il * S // 4) % 8 for il in range(8)}) == 8, \
        "8 lanes' 16-byte reads fall on 8 bank groups"
    k = [_int(plan.consts[8 * q:8 * q + 8]) for q in range(9)]
    words = v.as_strided((v.untyped_storage().nbytes() // 4,), (1,),
                         0).numpy().view(np.uint32)
    out = np.zeros(rows * n * A * 8, dtype=np.uint32)
    written = np.zeros(rows * n * A * 8, dtype=np.int64)
    reads = set()
    for tile in range(rows * tpr):                # a warp each
        row = tile // tpr
        i0 = (tile - row * tpr) * T
        valid = min(T, n - i0)
        src = v.storage_offset() + row * stride + i0 * 8 * A
        buf = np.zeros(T * S, dtype=object)
        for c in range(valid * CH):               # the cp.async copies
            pt, sub = divmod(c, CH)
            buf[pt * S + sub * 4:pt * S + sub * 4 + 4] = \
                words[src + 4 * c:src + 4 * c + 4]
            reads.update(range(src + 4 * c, src + 4 * c + 4))
        for q in range(len(plan.items)):          # the items, in turn
            code = plan.code >> (6 * q)
            kind, j = code & 7, (code >> 3) & 7
            assert (kind, j) == plan.items[q]
            two = kind == TM.SCALE_MUL2
            assert j * 8 + (16 if two else 8) <= 8 * A
            for lane in range(valid):
                e = lane * S + j * 8
                a = _int(buf[e:e + 8])
                b = _int(buf[e + 8:e + 16]) if two else None
                ks = (k[j], k[j + 1] if two else None,
                      k[6 + j // 2] if two else None)
                r0, r1 = _op(kind, a, b, ks)
                buf[e:e + 8] = _words([r0])[0]
                if two:
                    buf[e + 8:e + 16] = _words([r1])[0]
        dst = (row * n + i0) * 8 * A
        for c in range(valid * CH):               # the stores
            pt, sub = divmod(c, CH)
            out[dst + 4 * c:dst + 4 * c + 4] = \
                buf[pt * S + sub * 4:pt * S + sub * 4 + 4]
            written[dst + 4 * c:dst + 4 * c + 4] += 1
    assert (written == 1).all(), "every output word written exactly once"
    return (torch.from_numpy(out.view(np.int32)).reshape(t.shape), reads)


def _view_words(t: torch.Tensor):
    """The storage offsets of t's elements."""
    idx = torch.arange(t.untyped_storage().nbytes() // 4, dtype=torch.int64)
    return set(idx.as_strided(t.shape, t.stride(),
                              t.storage_offset()).flatten().tolist())


TWO_P_EDGES = [0, 1, P - 1, P, 2 * P - 1, 2 * P]


def _layouts():
    """(name, tensor, spec, ext): each caller's layout at a small size."""
    g1_tab = _points((4, 2 * 300, 2), 1)
    g2_tab = _points((1, 2 * 300, 4), 2)
    g1_buckets = _points((2, 3, 33, 3), 3)
    g1_buckets.view(-1, 8)[1::3][:len(TWO_P_EDGES)] = torch.from_numpy(
        _words(TWO_P_EDGES).view(np.int32))          # y up to 2p
    g2_buckets = _points((2, 1, 41, 6), 4, edges=[0, 1, P - 1])
    return [
        ("phi g1, slice view [:, n:]", g1_tab[:, 300:], (BETA1, None), 1),
        ("phi g2, slice view [:, n:]", g2_tab[:, 300:],
         (BETA2, BETA2, None, None), 1),
        ("phi g1, whole table", g1_tab, (BETA1, None), 1),
        ("neg g1, strided head", g1_buckets[..., :32, :, :],
         (None, "neg_rx", None), 1),
        ("neg g2, strided head, ragged", g2_buckets[..., :40, :, :],
         (None, "neg", None), 2),
        ("iso back, window totals", _points((10, 1, 6), 5),
         (ISO["w2i"], ISO["w3i"], None), 2),
        ("iso forward, ragged", _points((37, 6), 6),
         (ISO["w2"], ISO["w3"], None), 2),
        ("rescale, ragged", _points((1, 200, 4), 7), (ISO["w2"], ISO["w3"]),
         2),
        ("mixed ext 1", _points((3, 70, 6), 8, edges=[0, 1, P - 1]),
         (BETA1, "neg", None, "neg", 12345, None), 1),
        ("mixed ext 2", _points((2, 50, 6), 9),
         ("neg", (BETA1, 77), None), 2),
    ]


LAYOUTS = _layouts()


@pytest.mark.parametrize("case", range(len(LAYOUTS)),
                         ids=[c[0] for c in LAYOUTS])
def test_fq_scale_kernel_model_matches_plain(case):
    """Every output word once, reads inside the view, and the plain
    version's words."""
    _, t, spec, ext = LAYOUTS[case]
    got, reads = kernel_model(t, spec, ext)
    assert reads <= _view_words(t)
    assert torch.equal(got, TM.fq_scale_plain(t, spec, ext))
    assert torch.equal(got, TM.fq_scale(t, spec, ext))


def test_fq_scale_kernel_model_rows_of_one_point():
    """70,000 rows of one point that are not back to back: a tile a
    row."""
    t = _points((70000, 2, 2), 10)[:, :1]
    got, reads = kernel_model(t, ("neg", None), 1)
    assert reads <= _view_words(t)
    assert torch.equal(got, TM.fq_scale_plain(t, ("neg", None), 1))


@pytest.mark.parametrize("op,vals", [
    ("neg", [0, 1, 2, P - 2, P - 1]),
    ("neg_rx", TWO_P_EDGES)])
def test_fq_scale_negations_on_edge_words(op, vals):
    """p - a (0 for 0) and 2p - a (2p for 0) on the edges of the
    canonical and the relaxed range, word for word, in the plain version
    and the kernel's model."""
    t = torch.from_numpy(_words(vals).view(np.int32)).reshape(-1, 1, 8)
    want = [(P - a) % P if op == "neg" else 2 * P - a for a in vals]
    plain = TM.fq_scale_plain(t, (op,), 1)
    model, _ = kernel_model(t, (op,), 1)
    for got in (plain, model):
        assert [_int(w) for w in got.numpy().view(np.uint32)[:, 0]] == want


@pytest.mark.parametrize("spec,ext", [
    ((BETA1, None), 1), ((BETA2, BETA2, None, None), 1),
    ((None, "neg_rx", None), 1), ((None, "neg", None), 2),
    ((ISO["w2"], ISO["w3"]), 2), ((ISO["w2i"], ISO["w3i"], None), 2),
    (((P + 5, 7), "neg", (P + 1, 3)), 2)])
def test_fq_scale_cached_plan_equals_fresh(spec, ext):
    """The plan a wrapper call reuses (constants packed once a process)
    equals a freshly packed one; its words are the constants mod p and,
    for an Fq2 product, the sum of the pair."""
    cached = TM._scale_plan(spec, ext)
    assert TM._scale_plan(tuple(spec), ext) is cached
    fresh = TM._scale_plan.__wrapped__(spec, ext)
    assert cached.items == fresh.items and cached.code == fresh.code
    assert list(cached.consts) == list(fresh.consts)
    words = [_int(fresh.consts[8 * q:8 * q + 8]) for q in range(9)]
    for m, op in enumerate(spec):
        if isinstance(op, (str, type(None))):
            continue
        if ext == 1:
            assert words[m] == op % P
        else:
            assert words[2 * m:2 * m + 2] == [op[0] % P, op[1] % P]
            assert words[6 + m] == op[0] % P + op[1] % P
    comps = sorted(j + e for kind, j in fresh.items
                   for e in range(2 if kind == TM.SCALE_MUL2 else 1))
    assert comps == [m * ext + e for m, op in enumerate(spec)
                     if op is not None for e in range(ext)]


def test_bench_fq_scale_tool_on_cpu():
    """The timing tool's cases at a tiny size: every caller's shape,
    each equal to the plain version; no device time off the card."""
    from rapidsnark_tpu_torch.tools import bench_fq_scale
    out = bench_fq_scale.main(["1", "8"], device="cpu")
    assert out["device"] == "cpu"
    assert [c["tag"][0] for c in out["cases"]] == \
        ["phi", "phi", "neg", "neg", "back", "rescale"]
    assert all(c["equal"] and c["device_ms"] is None and c["bound_ms"] > 0
               for c in out["cases"])
    assert out["cases"][0]["case"] == "phi g1 4 x 2^8 the 2^8 table"
