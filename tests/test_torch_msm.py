"""Port MSM (rapidsnark_tpu_torch/ops/msm.py, ops/glv.py) vs the JAX
package on the same numpy inputs.

Tolerances: exact values for digits, GLV halves and signs; window totals
are group-equal (affine-normalized, G1's relaxed coordinates reduced mod
p): projective Z depends on the order of the adds, and a stable torch
sort may order equal digits differently from lax.sort_key_val."""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rapidsnark_tpu.ops import glv as JG
from rapidsnark_tpu.ops import msm as JM
from rapidsnark_tpu.ops.curve import G1P as JG1P, G2P as JG2P
from rapidsnark_tpu.ref import curve as refc
from rapidsnark_tpu.ref.field import R_FR
from rapidsnark_tpu.utils import points as PT
from rapidsnark_tpu_torch.ops import glv as TG
from rapidsnark_tpu_torch.ops import msm as TM
from rapidsnark_tpu_torch.ops.curve import G1P, G2P
from rapidsnark_tpu_torch.utils.hostcurve import G1H, G2H

from test_torch_field import limbs, rand_vals

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def _scalar_words(n, batch=(), seed=0):
    """(*batch, n, 8) uint32 words of scalars < r (a few zeros/ones)."""
    vals = rand_vals(R_FR, n * int(np.prod(batch or (1,))), seed=seed)
    vals[0] = 0
    vals[1] = 1
    w = limbs(vals)
    w = (w[0::2] | (w[1::2] << 16)).T
    return np.ascontiguousarray(w.reshape(batch + (n, 8)))


def _t(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32))


def test_glv_decompose_matches_jax():
    sc = _scalar_words(64, (2,), seed=1)
    for jp, tp in ((JG.G1_PARAMS, TG.G1_PARAMS), (JG.G2_PARAMS, TG.G2_PARAMS)):
        jw, jn = jax.jit(lambda s: JG.decompose(jp, s))(jnp.asarray(sc))
        tw, tn = TG.decompose(tp, _t(sc))
        assert np.array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
        assert np.array_equal(tn.numpy(), np.asarray(jn).astype(np.int64))


@pytest.mark.parametrize("c", [4, 13])
def test_digits_match_jax(c):
    sc = _scalar_words(96, (2,), seed=2)
    want = np.asarray(JM.window_digits(jnp.asarray(sc), c))
    assert np.array_equal(TM.window_digits(_t(sc), c).numpy(), want)
    # trailing-word carries and grouped signed digits
    jc = JM.signed_digit_carries(jnp.asarray(sc), c)
    tc = TM.signed_digit_carries(_t(sc), c)
    assert np.array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    s9 = np.concatenate([sc, np.zeros(sc.shape[:-1] + (1,), np.uint32)], -1)
    jg = JM.group_signed_digits(jnp.asarray(s9), jc, 2, 3, c)
    tg = TM.group_signed_digits(_t(s9), tc, 2, 3, c)
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    # the GLV layout: word axis leading
    dw, _ = TG.decompose(TG.G1_PARAMS, _t(sc))
    jdw = jnp.asarray(dw.numpy().astype(np.uint32))
    jc = JM.signed_digit_carries(jdw, c, JG.GLV_BITS, lead=True)
    tc = TM.signed_digit_carries(dw, c, TG.GLV_BITS, lead=True)
    assert np.array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    jg = JM.group_signed_digits(jdw, jc, 1, 2, c, lead=True)
    tg = TM.group_signed_digits(dw, tc, 1, 2, c, lead=True)
    assert np.array_equal(tg.numpy(), np.asarray(jg))


def test_window_bits_and_padding_match_jax():
    for n in (1, 256, 300, 1 << 12, 1 << 17, 1 << 20):
        assert TM.pad_len(n) == JM.pad_len(n)


def _points(g2, n, seed):
    rng = random.Random(seed)
    grp, gen = (refc.G2, refc.G2_GEN) if g2 else (refc.G1, refc.G1_GEN)
    pts = [grp.mul(gen, rng.randrange(1, R_FR)) for _ in range(n)]
    pts[2] = None                          # infinity lane
    pts[5] = pts[4]                        # duplicate point
    conv = PT.g2_affine_to_mont_limbs if g2 else PT.g1_affine_to_mont_limbs
    arr = np.stack([conv(p) for p in pts])                 # (n, A, 16)
    return pts, arr[..., 0::2] | (arr[..., 1::2] << 16)    # (n, A, 8)


def _affine_window(wp, g2, w, b):
    """Port window total (W, *b, L, 8) -> affine host point."""
    cs = [wp[w, b, k] for k in range(wp.shape[2])]
    ints = [PT._coord(np.stack([c & 0xFFFF, c >> 16], -1).reshape(16))
            for c in cs]
    if g2:
        return G2H.to_affine(((ints[0], ints[1]), (ints[2], ints[3]),
                              (ints[4], ints[5])))
    return G1H.to_affine(tuple(ints))


def _affine_window_jax(out, g2, w, b):
    if g2:
        (x0, x1), (y0, y1), (z0, z1) = [tuple(np.asarray(e) for e in c)
                                        for c in out]
        cc = lambda a0, a1: (a0[:, w, b], a1[:, w, b])  # noqa: E731
        return PT.proj_to_affine_g2(cc(x0, x1), cc(y0, y1), cc(z0, z1))
    x, y, z = (np.asarray(c) for c in out)
    return PT.proj_to_affine_g1(x[:, w, b], y[:, w, b], z[:, w, b])


@pytest.mark.parametrize("g2", [False, True])
def test_msm_windows_group_equal_to_jax(g2):
    """msm(combine=False) at c = 4 over 256 points: a 4-row G1 batch, and
    G2 on the iso-twist; every window total is group-equal to the JAX
    package's, and the host combine of row 0 equals the oracle MSM."""
    n, c = 256, 4
    rows = 1 if g2 else 4
    pts, words = _points(g2, n, seed=3)
    sc = _scalar_words(n, (rows,), seed=4)
    table = np.broadcast_to(words, (rows,) + words.shape).copy()
    if g2:
        cs = [jnp.asarray(np.moveaxis(table[:, :, k], -1, 0))
              for k in range(4)]
        jpts = JM.g2_rescale_packed(((cs[0], cs[1]), (cs[2], cs[3])))
        tpts = TM.g2_rescale_packed(_t(table))
    else:
        jpts = tuple(jnp.asarray(np.moveaxis(table[:, :, k], -1, 0))
                     for k in range(2))
        tpts = _t(table)
    curve_j, curve_t = (JG2P, G2P) if g2 else (JG1P, G1P)
    want = jax.jit(lambda p, s: JM.msm(curve_j, p, s, c, 5, combine=False))(
        jpts, jnp.asarray(sc))
    got = TM.msm(curve_t, tpts, _t(sc), c, 5).numpy().view(np.uint32)
    nwin = got.shape[0]
    assert nwin == -(-JG.GLV_BITS // c)
    grp = refc.G2 if g2 else refc.G1
    for w in range(nwin):
        for b in range(rows):
            g = _affine_window(got, g2, w, b)
            e = _affine_window_jax(want, g2, w, b)
            assert (g is None and e is None) or grp.eq(g, e)
    H = G2H if g2 else G1H
    tot = H.combine_windows([H.from_affine(_affine_window(got, g2, w, 0))
                             for w in range(nwin)], c)
    ks = [int.from_bytes(sc[0, i].tobytes(), "little") for i in range(n)]
    expect = grp.msm(pts, ks)
    assert grp.eq(H.to_affine(tot), expect)


def test_g2_rescale_matches_jax():
    _, words = _points(True, 16, seed=5)
    cs = [jnp.asarray(np.moveaxis(words[:, k], -1, 0)) for k in range(4)]
    want = JM.g2_rescale_packed(((cs[0], cs[1]), (cs[2], cs[3])))
    got = TM.g2_rescale_packed(_t(words)).numpy().view(np.uint32)
    leaves = [want[0][0], want[0][1], want[1][0], want[1][1]]
    for k, leaf in enumerate(leaves):
        assert np.array_equal(got[:, k], np.asarray(leaf).T)


def test_segmented_window_bits_match_jax():
    """Every slice of a segmented msm scans the JAX package's window
    count (n_windows over a GLV half, or over a whole scalar without
    GLV) in groups of group_size(nwin, G): the largest divisor of the
    window count no larger than G, as the JAX package's msm groups them."""
    for c in range(1, 17):
        for bits in (JG.GLV_BITS, JM.SCALAR_BITS):
            nwin = JM.n_windows(c, bits)
            assert nwin == -(-bits // c)
            for G in range(1, 11):
                want = max(g for g in range(1, min(G, nwin) + 1)
                           if nwin % g == 0)
                assert TM.group_size(nwin, G) == want


def _jax_table(table, g2):
    """(rows, n, A, 8) words -> the JAX package's packed point pytree
    (G2 on the iso-twist)."""
    cs = [jnp.asarray(np.moveaxis(table[:, :, k], -1, 0))
          for k in range(table.shape[2])]
    if g2:
        return JM.g2_rescale_packed(((cs[0], cs[1]), (cs[2], cs[3])))
    return tuple(cs)


def _affine_point(pt, g2, b):
    """The port's combined result (rows, L, 8) -> affine host point."""
    return _affine_window(pt[None], g2, 0, b)


def _affine_point_jax(out, g2, b):
    """The JAX package's combined result (leaves (16, rows))."""
    lift = lambda e: np.asarray(e)[:, None]  # noqa: E731
    if g2:
        out = tuple(tuple(lift(e) for e in c) for c in out)
    else:
        out = tuple(lift(c) for c in out)
    return _affine_window_jax(out, g2, 0, b)


def _check_combined_point(g2, glv):
    """msm(combine=True), c = 8 over 256 points in 16-window groups: one
    point per row, group-equal to the JAX package's msm with the same
    arguments and to the oracle MSM."""
    n, c, G = 256, 8, 16
    rows = 1 if g2 else 2
    pts, words = _points(g2, n, seed=12)
    sc = _scalar_words(n, (rows,), seed=13)
    table = np.broadcast_to(words, (rows,) + words.shape).copy()
    curve_j, curve_t = (JG2P, G2P) if g2 else (JG1P, G1P)
    tpts = TM.g2_rescale_packed(_t(table)) if g2 else _t(table)
    want = jax.jit(lambda p, s: JM.msm(curve_j, p, s, c, G, combine=True,
                                       glv=glv))(
        _jax_table(table, g2), jnp.asarray(sc))
    got = TM.msm(curve_t, tpts, _t(sc), c, G, combine=True, glv=glv)
    assert got.shape == (rows, 6 if g2 else 3, 8)
    got = got.numpy().view(np.uint32)
    grp = refc.G2 if g2 else refc.G1
    for b in range(rows):
        assert grp.eq(_affine_point(got, g2, b),
                      _affine_point_jax(want, g2, b))
    ks = [int.from_bytes(sc[0, i].tobytes(), "little") for i in range(n)]
    assert grp.eq(_affine_point(got, g2, 0), grp.msm(pts, ks))


def test_glv_switch_reads_environment(monkeypatch):
    """glv=None follows RSTPU_GLV as ops/glv.enabled reads it: ceil(128/c)
    windows with it, ceil(256/c) without (an all-infinity table, whose
    columns the plain scan skips)."""
    pts = _t(np.zeros((1, 256, 2, 8), np.uint32))
    sc = _t(np.zeros((1, 256, 8), np.uint32))
    monkeypatch.delenv("RSTPU_GLV", raising=False)
    assert TG.enabled() and TM.msm(G1P, pts, sc, 8, 16).shape[0] == 16
    monkeypatch.setenv("RSTPU_GLV", "0")
    assert not TG.enabled()
    assert TM.msm(G1P, pts, sc, 8, 16).shape[0] == 32
    assert TM.msm(G1P, pts, sc, 8, 16, glv=True).shape[0] == 16
    from rapidsnark_tpu_torch import config as TCFG
    from rapidsnark_tpu import config as JCFG
    for env in (None, "0", "1"):
        if env is None:
            monkeypatch.delenv("RSTPU_NTT_SEQ", raising=False)
        else:
            monkeypatch.setenv("RSTPU_NTT_SEQ", env)
        for power in (20, 22, 23, 24):
            assert TCFG.ntt_sequential(power) == JCFG.ntt_sequential(power)


def test_unported_options_raise():
    """No option of msm is left unported: combine=True, which used to
    raise NotImplementedError, returns one point per row (the identity
    for zero scalars). What still raises is a segment the entry axis
    cannot be cut by, with GLV or without."""
    pts = _t(np.zeros((1, 256, 2, 8), np.uint32))
    sc = _t(np.zeros((1, 256, 8), np.uint32))
    for kw in ({"combine": True}, {"combine": True, "glv": False}):
        out = TM.msm(G1P, pts, sc, 8, 16, **kw)
        assert out.shape == (1, 3, 8)
        assert _affine_point(out.numpy().view(np.uint32), False, 0) is None
    for kw in ({"segment": 192}, {"segment": 192, "glv": False},
               {"segment": 100, "glv": False}):
        with pytest.raises(ValueError, match="segment"):
            TM.msm(G1P, pts, sc, 8, 16, **kw)
