"""The plain versions of the front kernels (rapidsnark_tpu_torch/ops/front.py)
against the JAX package's front arithmetic on the same numpy inputs:
`fr_slot_acc` against FR.mul, the slot sum, the spilled records'
segment_sum and reduce_wide as rapidsnark_tpu/prover.py `_acc` runs them;
`fr_pointwise` against FR.mul, FR.sub and FR.from_mont. Beside them the
table builders the kernel reads (the slots, the spilled records' CSR and
work list) against numpy loops.

Tolerance: exact words (canonical residues are unique).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rapidsnark_tpu.ops import field as JF
from rapidsnark_tpu.ops import msm as JM
from rapidsnark_tpu.ref.field import R_FR
from rapidsnark_tpu_torch.ops import front as FRONT

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def _words(shape, seed) -> np.ndarray:
    """Random canonical Fr elements as (*shape, 8) uint32 words."""
    rs = np.random.RandomState(seed)
    w = rs.randint(0, 1 << 32, size=tuple(shape) + (8,), dtype=np.uint64)
    w[..., 7] %= R_FR >> 224
    return w.astype(np.uint32)


def _jl(w: np.ndarray):
    """(m, 8) words -> JAX (16, m) limbs."""
    return JM.unpack_limb_rows(jnp.asarray(w.T))


def _jw(limbs) -> np.ndarray:
    """JAX (16, m) limbs -> (m, 8) words."""
    return np.ascontiguousarray(np.asarray(JM.pack_limb_rows(limbs)).T)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_acc(wit, cs, cv, K, rows, spill=None):
    """The JAX package's accumulation: products, the slot sum of their
    limbs, segment_sum of the spilled ones, reduce_wide."""
    prod = JF.FR.mul(_jl(wit[cs]), _jl(cv))
    acc = JF.pack(prod).reshape(rows, K, 16).sum(axis=1, dtype=jnp.uint32)
    if spill is not None:
        ls, lv, lrow = spill
        lprod = JF.FR.mul(_jl(wit[ls]), _jl(lv))
        acc = acc + jax.ops.segment_sum(JF.pack(lprod), jnp.asarray(lrow),
                                        num_segments=rows)
    acc = jnp.concatenate([acc, jnp.zeros((rows, 2), jnp.uint32)], axis=1)
    return _jw(JF.FR.reduce_wide(JF.unpack(acc)))


# spilled records: none; 100 on row 3 and a few on rows 0 and 39; two
# chunks and a remainder on row 3 (a row longer than a chunk) and a few
SPILLS = {"none": None, "short": 100, "long": 2 * FRONT.SPILL_CHUNK + 300}


@pytest.mark.parametrize("spilled", sorted(SPILLS))
@pytest.mark.parametrize("K", [1, 2, 3])
def test_slot_acc_plain_matches_jax(K, spilled):
    """40 rows of K slots (one in five empty), given to the port
    slot-major; spilled records in no order, given to the port sorted by
    row (make_spill)."""
    nvars, rows = 50, 40
    rs = np.random.RandomState(K)
    wit = _words((nvars,), 10 + K)
    cs = rs.randint(0, nvars, size=rows * K)
    cv = _words((rows * K,), 20 + K)
    cs[::5] = 0
    cv[::5] = 0
    spill, tspill = None, None
    if SPILLS[spilled]:
        lrow = np.concatenate([np.full(SPILLS[spilled], 3), [0, 39, 39]])
        rs.shuffle(lrow)
        ls = rs.randint(0, nvars, size=lrow.size)
        lv = _words((lrow.size,), 30 + K)
        spill = (ls, lv, lrow)
        tspill, _ = FRONT.make_spill(_t(ls), _t(lv).view(torch.int32),
                                     _t(lrow), rows)
        assert tspill.items.shape[0] == 2 + -(-SPILLS[spilled]
                                              // FRONT.SPILL_CHUNK)
    want = _jax_acc(wit, cs, cv, K, rows, spill)
    got = FRONT.fr_slot_acc(
        _t(wit).view(torch.int32),
        _t(cs.reshape(rows, K).T.astype(np.int32)),
        _t(cv.reshape(rows, K, 8).transpose(1, 0, 2)).view(torch.int32),
        tspill)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_spill_csr_sorts_by_row_stably():
    rows = torch.tensor([4, 1, 4, 0, 1, 4])
    order, off = FRONT.spill_csr(rows, 6)
    assert order.dtype == off.dtype == torch.int32
    assert order.tolist() == [3, 1, 4, 0, 2, 5]
    assert off.tolist() == [0, 1, 3, 3, 3, 6, 6]


def _work_numpy(counts, chunk):
    """spill_work's lists by a loop per row."""
    items, multi, beg = [], [], 0
    for r, c in enumerate(counts):
        first = len(items)
        for lo in range(0, c, chunk):
            items.append((r, beg + lo, beg + min(lo + chunk, c)))
        if len(items) - first > 1:
            multi.append((r, first, len(items)))
        beg += c
    return items, multi


@pytest.mark.parametrize("counts", [
    [0, 0, 0],                      # nothing spilled
    [0, 4, 0, 1],                   # a row of exactly one chunk
    [3, 0, 11, 2, 0],               # several chunks and a remainder
    [2, 0, 0, 8],                   # the last row, two whole chunks
    [5, 4, 12, 0, 1, 9, 0, 0, 4]])
def test_spill_work_matches_numpy(counts, chunk=4):
    off = torch.zeros(len(counts) + 1, dtype=torch.int32)
    off[1:] = torch.cumsum(torch.tensor(counts), 0)
    items, multi = FRONT.spill_work(off, chunk)
    want_items, want_multi = _work_numpy(counts, chunk)
    assert items.dtype == multi.dtype == torch.int32
    assert items.reshape(-1, 3).tolist() == [list(t) for t in want_items]
    assert multi.reshape(-1, 3).tolist() == [list(t) for t in want_multi]


def test_slot_tables_bin_in_order():
    """Records of rows 2, 0, 2, 2, 1, 2 in two slots a row: each row's
    first two in its slots (slot-major), the rest past them in record
    order with their rank minus K."""
    rows = torch.tensor([2, 0, 2, 2, 1, 2])
    s = torch.tensor([10, 11, 12, 13, 14, 15])
    val = (torch.arange(6, dtype=torch.int32) + 1)[:, None].repeat(1, 8)
    cs, cv, left, lrank = FRONT.slot_tables(s, val, rows, 4, 2)
    assert cs.dtype == torch.int32
    assert cs.tolist() == [[11, 14, 10, 0], [0, 0, 12, 0]]
    assert cv[..., 0].tolist() == [[2, 5, 1, 0], [0, 0, 3, 0]]
    assert left.tolist() == [3, 5] and lrank.tolist() == [0, 1]


@pytest.mark.parametrize("op,ashape,bshape", [
    ("mul", (33,), (33,)), ("mul", (3, 33), (33,)), ("mul", (2, 5), ()),
    ("sub", (33,), (33,)), ("h", (33,), (33,))])
def test_pointwise_plain_matches_jax(op, ashape, bshape):
    """Same shapes, a row broadcast over a stack, one element over all."""
    a, b = _words(ashape, 40), _words(bshape, 41)
    c = _words(ashape, 42) if op == "h" else None
    m = int(np.prod(ashape))
    bb = np.broadcast_to(b, tuple(ashape) + (8,)).reshape(m, 8)
    x, y = _jl(a.reshape(m, 8)), _jl(bb)
    if op == "mul":
        want = JF.FR.mul(x, y)
    elif op == "sub":
        want = JF.FR.sub(x, y)
    else:
        want = JF.FR.from_mont(JF.FR.sub(JF.FR.mul(x, y),
                                         _jl(c.reshape(m, 8))))
    got = FRONT.fr_pointwise(op, _t(a).view(torch.int32),
                             _t(b).view(torch.int32),
                             None if c is None else _t(c).view(torch.int32))
    assert got.shape == tuple(ashape) + (8,)
    assert np.array_equal(got.numpy().view(np.uint32).reshape(m, 8),
                          _jw(want))


def test_front_wrappers_refuse_bad_arguments():
    a = torch.zeros((3, 4, 8), dtype=torch.int32)
    for args in (("mul", a, a[0, :3]),           # not a trailing part
                 ("h", a, a[0]),                 # h without c
                 ("mul", a, a[0], a),            # c without h
                 ("pow", a, a[0])):
        with pytest.raises(ValueError, match="fr_pointwise"):
            FRONT.fr_pointwise(*args)
    wit = torch.zeros((5, 8), dtype=torch.int32)
    cs = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="fr_slot_acc"):
        FRONT.fr_slot_acc(wit, cs, torch.zeros((3, 2, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="fr_slot_acc"):
        FRONT.fr_slot_acc(wit, cs.reshape(-1),
                          torch.zeros((6, 8), dtype=torch.int32))
    spill, _ = FRONT.make_spill(torch.tensor([1]), wit[:1],
                                torch.tensor([0]), 4)
    with pytest.raises(ValueError, match="fr_slot_acc"):
        FRONT.fr_slot_acc(wit, cs, torch.zeros((2, 3, 8), dtype=torch.int32),
                          spill)
