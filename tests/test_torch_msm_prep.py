"""The MSM's scalar and point preparation of the port (ops/msm.glv_digits
and ops/msm.fq_scale, plain versions on the CPU) against the JAX
package, on the same numpy inputs, and the three MSM measurement tools
of rapidsnark_tpu_torch/tools run on the CPU at a tiny size.

glv_digits is held against the JAX package's decompose +
signed_digit_carries + group_signed_digits (and the sign fold the JAX
msm applies) for both GLV halves and without GLV, on an explicit table
of edge scalars (ops/glv.edge_scalars) and random ones, and by a
hypothesis property against the JAX package's Python-int oracle
(GLVParams.decompose_host) with the recode written out in Python.
fq_scale is held against the JAX package's phi, iso-twist scaling (both
ways), negation and table rescale. powers_mont against the JAX package's
table builder. Tolerance: exact words everywhere (digits are integers;
canonical Montgomery residues are unique, and the relaxed negation is
the same 2p - a)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from rapidsnark_tpu.ops import curve as JC
from rapidsnark_tpu.ops import glv as JG
from rapidsnark_tpu.ops import msm as JM
from rapidsnark_tpu.ops import ntt as JN
from rapidsnark_tpu.ref.field import P, R_FR, fr_w
from rapidsnark_tpu_torch.ops import glv as TG
from rapidsnark_tpu_torch.ops import msm as TM
from rapidsnark_tpu_torch.ops import ntt as TN
from rapidsnark_tpu_torch.ops.curve import G1P, G2P, G2P_ISO

from test_torch_field import words_of

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)

CS = [4, 8, 11, 13, 16]
PARAMS = {"g1": (TG.G1_PARAMS, JG.G1_PARAMS), "g2": (TG.G2_PARAMS,
                                                     JG.G2_PARAMS)}


def _words(vals) -> np.ndarray:
    """ints < 2^256 -> (n, 8) uint32 little-endian words."""
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], dtype=np.uint32).reshape(len(vals), 8)


def _t(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32))


def _scalars(seed=0):
    """(2, 128, 8) words: every edge scalar of both groups, then random
    scalars < r from a numpy seed."""
    vals = TG.edge_scalars(TG.G1_PARAMS) + TG.edge_scalars(TG.G2_PARAMS)
    rs = np.random.RandomState(seed)
    while len(vals) < 256:
        w = rs.randint(0, 1 << 32, size=8, dtype=np.uint64)
        vals.append(sum(int(x) << (32 * i) for i, x in enumerate(w)) % R_FR)
    return _words(vals[:256]).reshape(2, 128, 8)


_JAX_DIGITS = {}


def _jax_digits(sc, c, jparams, half):
    """The JAX package's encoded digits of every window, as the JAX msm
    forms them: (W, *b, H*n)."""
    key = (c, None if jparams is None else id(jparams), half)
    fn = _JAX_DIGITS.get(key)
    if fn is None:
        def run(s):
            if jparams is None:
                nwin = -(-JM.SCALAR_BITS // c)
                carries = JM.signed_digit_carries(s, c)
                s9 = jnp.concatenate(
                    [s, jnp.zeros(s.shape[:-1] + (1,), s.dtype)], axis=-1)
                return JM.group_signed_digits(s9, carries, 0, nwin, c)
            nwin = -(-JG.GLV_BITS // c)
            w, neg = JG.decompose(jparams, s)
            if half is not None:
                n = s.shape[-2]
                w = w[..., half * n:(half + 1) * n]
                neg = neg[..., half * n:(half + 1) * n]
            carries = JM.signed_digit_carries(w, c, JG.GLV_BITS, lead=True)
            dg = JM.group_signed_digits(w, carries, 0, nwin, c, lead=True)
            return dg ^ neg[None].astype(dg.dtype)
        fn = _JAX_DIGITS[key] = jax.jit(run)
    return np.asarray(fn(jnp.asarray(sc))).astype(np.int64)


@pytest.mark.parametrize("mode", ["k1", "k2", "both", "no_glv"])
@pytest.mark.parametrize("c", CS)
def test_glv_digits_plain_match_jax(c, mode):
    """Every window's encoded digits of the edge table and random
    scalars, for both groups' GLV constants."""
    sc = _scalars(seed=c)
    half = {"k1": 0, "k2": 1, "both": None, "no_glv": None}[mode]
    groups = [(None, None)] if mode == "no_glv" else list(PARAMS.values())
    for tp, jp in groups:
        bits = JM.SCALAR_BITS if tp is None else JG.GLV_BITS
        nwin = -(-bits // c)
        got = TM.glv_digits(_t(sc), c, 0, nwin, tp, half)
        want = _jax_digits(sc, c, jp, half)
        assert got.dtype == torch.int64
        assert got.shape == want.shape == (nwin, 2, 128 * (
            2 if mode == "both" else 1))
        assert np.array_equal(got.numpy(), want)


def _recode(mag, neg, c, bits):
    """Encoded signed digits of a magnitude, its sign folded in: the
    recode written out on Python ints."""
    half, full = 1 << (c - 1), 1 << c
    out, carry = [], 0
    for w in range(-(-bits // c)):
        d = ((mag >> (w * c)) & (full - 1)) + carry
        enc = (full - d) * 2 + (d < full) if d >= half else d * 2
        out.append(enc ^ neg)
        carry = int(d >= half)
    return out


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, R_FR - 1), min_size=8, max_size=8),
       st.sampled_from(CS), st.sampled_from(sorted(PARAMS)))
def test_glv_digits_property(vals, c, group):
    """Random scalars < r: the plain digits of both halves and of the
    whole scalar equal the recode of the JAX package's Python-int
    decomposition oracle, and the signed digits of the two halves give
    k back as k1 + k2 lam (mod r)."""
    tp, jp = PARAMS[group]
    sc = _t(_words(vals))
    nwin = -(-JG.GLV_BITS // c)
    got = TM.glv_digits(sc, c, 0, nwin, tp).numpy()         # (W, 2n)
    whole = TM.glv_digits(sc, c, 0, -(-256 // c)).numpy()
    for i, k in enumerate(vals):
        a1, n1, a2, n2 = jp.decompose_host(k)
        assert list(got[:, i]) == _recode(a1, n1, c, JG.GLV_BITS)
        assert list(got[:, 8 + i]) == _recode(a2, n2, c, JG.GLV_BITS)
        assert list(whole[:, i]) == _recode(k, 0, c, 256)
        # the digits themselves give k back: sum_w d_w 2^(wc) per half
        def value(col):
            return sum((-(e >> 1) if e & 1 else e >> 1) << (w * c)
                       for w, e in enumerate(map(int, col)))
        assert (value(got[:, i]) + value(got[:, 8 + i]) * tp.lam - k) \
            % R_FR == 0


M32 = 0xFFFFFFFF


def _kernel_model(k, consts, half, c, w0, G, glv=True):
    """csrc/msm.cu's k_glv_digits for one entry, transcribed step by step
    on 32-bit words with 64-bit accumulators (the card's arithmetic)."""
    s = [(k >> (32 * i)) & M32 for i in range(8)] + [0]
    neg = 0
    if glv:
        g = [consts[0:5], consts[5:10]]
        t = [consts[10 + 6 * j:16 + 6 * j] for j in range(4)]
        cs = []
        for gj in g:                                       # babai
            p = [0] * 13
            for i in range(8):
                carry = 0
                for j in range(5):
                    v = s[i] * gj[j] + p[i + j] + carry
                    assert v < 1 << 64
                    p[i + j], carry = v & M32, v >> 32
                p[i + 5] = carry
            v = p[8] + (1 << 15)
            p[8] = v & M32
            for i in range(9, 13):
                v = p[i] + (v >> 32)
                p[i] = v & M32
            cs.append([((p[8 + m] >> 16) | (p[9 + m] << 16)) & M32
                       for m in range(4)] + [p[12] >> 16])
        x = [0] * 6 if half else s[:6]
        for a, b in zip(cs, (t[2], t[3]) if half else (t[0], t[1])):
            for i in range(5):                              # mad_lo6
                carry = 0
                for j in range(6 - i):
                    v = a[i] * b[j] + x[i + j] + carry
                    assert v < 1 << 64
                    x[i + j], carry = v & M32, v >> 32
        x[5] &= 0xFFFF
        neg = (x[5] >> 15) & 1
        v = 1
        for i in range(6):
            y = (~x[i] & M32) if neg else x[i]
            v = y + (v if neg else 0)
            x[i], v = v & M32, v >> 32
        s = x[:4] + [0] * 5
    mask, half_, full = (1 << c) - 1, 1 << (c - 1), 1 << c
    out, carry = [], 0
    for w in range(w0 + G):
        d = (s[0] & mask) + carry
        s = [((s[j] >> c) | (s[j + 1] << (32 - c))) & M32
             for j in range(8)] + [s[8] >> c]
        if w >= w0:
            enc = d * 2
            if d >= half_:
                enc = (full - d) * 2 + (d < full)
            out.append(enc ^ neg)
        carry = int(d >= half_)
    return out


@pytest.mark.parametrize("c", CS)
def test_glv_digits_kernel_model_matches_plain(c):
    """The kernel's word arithmetic, modelled in Python, gives the plain
    version's digits on the edge table and random scalars, both halves
    and without GLV, for every window."""
    sc = _scalars(seed=20 + c).reshape(-1, 8)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(r)) for r in sc]
    for tp in (TG.G1_PARAMS, TG.G2_PARAMS, None):
        nwin = -(-(256 if tp is None else 128) // c)
        consts = None if tp is None else list(TM._glv_consts(tp))
        for half in ((0,) if tp is None else (0, 1)):
            want = TM.glv_digits(_t(sc), c, 0, nwin, tp,
                                 None if tp is None else half).numpy()
            got = np.array([_kernel_model(k, consts, half, c, 0, nwin,
                                          tp is not None) for k in vals]).T
            assert np.array_equal(got, want)


def test_glv_digits_windows_and_layout():
    """A window range is a slice of all windows; both halves are the two
    halves side by side; bad requests raise."""
    sc = _t(_scalars(seed=3))
    p = TG.G1_PARAMS
    full = TM.glv_digits(sc, 13, 0, 10, p)
    assert torch.equal(TM.glv_digits(sc, 13, 3, 4, p), full[3:7])
    halves = [TM.glv_digits(sc, 13, 0, 10, p, half=h) for h in (0, 1)]
    assert torch.equal(torch.cat(halves, dim=-1), full)
    # rows of a strided view, as the segmented MSM slices them
    assert torch.equal(TM.glv_digits(sc[:, 32:96], 13, 0, 10, p, half=1),
                       halves[1][..., 32:96])
    for args in ((sc, 0, 0, 1, p), (sc, 17, 0, 1, p), (sc, 13, 8, 3, p),
                 (sc, 4, 0, 33, p), (sc, 3, 0, 1, None),
                 (sc, 13, 0, 1, None, 0), (sc, 13, 0, 1, p, 2)):
        with pytest.raises(ValueError):
            TM.glv_digits(*args)


def _table(g2, n, seed):
    """(n, A, 8) canonical affine words with (0,0) rows."""
    rs = np.random.RandomState(seed)
    A = 4 if g2 else 2
    w = rs.randint(0, 1 << 32, size=(n, A, 8), dtype=np.uint64)
    w[..., 7] %= P >> 224
    w = w.astype(np.uint32)
    w[::5] = 0
    return w


def _jax_leaves(words):
    """(*b, A, 8) words -> [leaf (8, *b)] per component."""
    return [jnp.asarray(np.moveaxis(words[..., k, :], -1, 0))
            for k in range(words.shape[-2])]


def _stack_leaves(leaves):
    return np.stack([np.moveaxis(np.asarray(a), 0, -1) for a in leaves],
                    axis=-2).astype(np.uint32)


@pytest.mark.parametrize("g2", [False, True])
def test_phi_matches_jax(g2):
    """beta * x on a table (on G2 the iso-twist's, as the MSM runs it),
    (0,0) rows fixed; the same through the GLV table slice."""
    w = _table(g2, 96, seed=11)
    curve, jcurve = (G2P_ISO, JC.G2P_ISO) if g2 else (G1P, JC.G1P)
    got = TM._phi(curve, _t(w)).numpy().view(np.uint32)
    leaves = _jax_leaves(w)
    if g2:
        x = JM._phi_apply_x(jcurve, (leaves[0], leaves[1]))
        want = _stack_leaves([x[0], x[1], leaves[2], leaves[3]])
    else:
        want = _stack_leaves([JM._phi_apply_x(jcurve, leaves[0]),
                              leaves[1]])
    assert np.array_equal(got, want)
    assert np.array_equal(got[::5], np.zeros_like(got[::5]))
    upper = TM._table_slice(curve, _t(w[None]), 96 + 32, 32)
    assert np.array_equal(upper[0].numpy().view(np.uint32), want[32:64])


def _proj_words(L, n, seed):
    rs = np.random.RandomState(seed)
    w = rs.randint(0, 1 << 32, size=(n, L, 8), dtype=np.uint64)
    w[..., 7] %= P >> 224
    return w.astype(np.uint32)


@pytest.mark.parametrize("back", [False, True])
def test_iso_scale_matches_jax(back):
    """Projective G2 points (x, y, z) to the iso-twist and back: x * w2,
    y * w3 by the JAX package's Fq2 products; z unchanged."""
    w = _proj_words(6, 64, seed=12 + back)
    w[3] = 0
    got = TM._iso_scale(G2P, _t(w), back).numpy().view(np.uint32)
    iso = JC.G2P_ISO.iso
    leaves = [JM.unpack_limb_rows(a) for a in _jax_leaves(w)]
    f2 = JC.G2P.f
    k2 = f2.const(iso["w2i" if back else "w2"], (64,))
    k3 = f2.const(iso["w3i" if back else "w3"], (64,))
    x, y = f2.mul_many([((leaves[0], leaves[1]), k2),
                        ((leaves[2], leaves[3]), k3)])
    want = _stack_leaves([JM.pack_limb_rows(a) for a in
                          (x[0], x[1], y[0], y[1], leaves[4], leaves[5])])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("g2", [False, True])
def test_point_neg_matches_jax(g2):
    """-P as the window group forms it: G1 by the relaxed law (2p - y,
    y in [0, 2p], 0 to 2p), G2 on the iso-twist canonically."""
    L = 6 if g2 else 3
    w = _proj_words(L, 64, seed=14)
    if not g2:                     # relaxed coordinates up to 2p
        two_p = _words([2 * P, 2 * P - 1, P, 0])
        w[:4, 1] = two_p
    else:
        w[:2, 2:4] = 0
    curve, jcurve = (G2P_ISO, JC.G2P_ISO) if g2 else (G1P, JC.G1P)
    got = TM.point_neg(curve, _t(w)).numpy().view(np.uint32)
    leaves = [JM.unpack_limb_rows(a) for a in _jax_leaves(w)]
    if g2:
        pt = ((leaves[0], leaves[1]), (leaves[2], leaves[3]),
              (leaves[4], leaves[5]))
        neg = jcurve.neg(pt)
        flat = [neg[0][0], neg[0][1], neg[1][0], neg[1][1], neg[2][0],
                neg[2][1]]
    else:
        flat = list(jcurve.neg_rx(tuple(leaves)))
    want = _stack_leaves([JM.pack_limb_rows(a) for a in flat])
    assert np.array_equal(got, want)


def test_g2_rescale_table_matches_jax():
    """The rescale of a table with a leading row axis and (0,0) points
    onto the iso-twist equals the JAX package's."""
    w = _table(True, 200, seed=15)[None]
    got = TM.g2_rescale_packed(_t(w)).numpy().view(np.uint32)
    cs = _jax_leaves(w)
    want = JM.g2_rescale_packed(((cs[0], cs[1]), (cs[2], cs[3])))
    assert np.array_equal(got, _stack_leaves(
        [want[0][0], want[0][1], want[1][0], want[1][1]]))


def test_fq_scale_refuses_bad_specs():
    t = _t(_proj_words(3, 4, seed=16))
    for spec, ext in (((None, None), 1), ((None,) * 3, 2), (("x",) * 3, 1),
                      ((None,) * 7, 1)):
        with pytest.raises(ValueError):
            TM.fq_scale(t if len(spec) != 7 else torch.zeros(
                (4, 7, 8), dtype=torch.int32), spec, ext)


@pytest.mark.parametrize("count", [1, 5, 1000, 4097])
def test_powers_mont_matches_jax(count, monkeypatch):
    """The outer product in several fr_pointwise steps (a small step
    size) gives the JAX package's table of powers."""
    monkeypatch.setattr(TN, "_POW_LANES", 256)
    root = fr_w(14)
    got = TN.powers_mont(root, count, device="cpu").numpy().view(np.uint32)
    assert np.array_equal(got, words_of(JN._powers_mont(root, count)))


# -- the three MSM tools, on the CPU at a tiny size -------------------------

def test_bench_msm_phases_tool_on_cpu():
    from rapidsnark_tpu_torch.tools import bench_msm_phases
    out = bench_msm_phases.main(["8", "4", "32", "1", "g1", "1"],
                                device="cpu")
    assert out["digits_equal_plain"] and out["device"] == "cpu"
    assert set(out["stages_ms"]) == set(bench_msm_phases.STAGES)
    assert set(out["deltas_ms"]) == {"digits", "sort", "gather", "scan",
                                     "extraction"}
    assert out["G"] == 32 and out["groups_per_slice"] == 1


def test_msm_ablate_tool_on_cpu():
    from rapidsnark_tpu_torch.tools import msm_ablate
    out = msm_ablate.main(["8", "1", "0", "4", "1", "32"], device="cpu")
    assert set(out["stages_ms"]) == {"msm", "digits", "sort", "gather",
                                     "scan_extract"}
    assert set(out["gather_ms"]) == {"gather_cols", "index_select_move",
                                     "dma_gather", "dma_gather_move"}
    assert out["gather_equal"] and out["gather_rows"] == 32 * 512


def test_sweep_msm_tool_on_cpu():
    from rapidsnark_tpu_torch.tools import sweep_msm
    out = sweep_msm.main(["g1", "8", "4", "0", "1", "1", "32"], device="cpu")
    assert [(ln["curve"], ln["c"], ln["windows"]) for ln in out["lines"]] \
        == [("g1", 4, 32)]
    assert out["lines"][0]["ms"] > 0


def test_edge_scalars_reach_the_edges():
    """The edge table holds both sides of a rounding step of c1 and c2,
    negative halves, and halves next to the bound."""
    for tp, jp in PARAMS.values():
        vals = TG.edge_scalars(tp)
        assert all(0 <= k < R_FR for k in vals)
        mags = [jp.decompose_host(k) for k in vals]
        assert any(n1 for _, n1, _, _ in mags) and any(
            n2 for _, _, _, n2 in mags)
        assert max(max(a1, a2) for a1, _, a2, _ in mags) > tp.bound // 2
        steps = set()
        for k in vals:
            for g in (tp.g1, tp.g2):
                lo = (k * g + (1 << 271)) >> 272
                hi = ((k + 1) * g + (1 << 271)) >> 272
                if hi != lo and (k + 1) in vals:
                    steps.add(g)
        assert steps == {tp.g1, tp.g2}
