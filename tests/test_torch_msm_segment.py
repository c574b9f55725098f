"""The port's segmented MSM (`segment`, `row_slice` of
rapidsnark_tpu_torch/ops/msm.py) vs its whole-axis result and the JAX
package's segmented MSM, on the same numpy inputs.

Tolerance: window totals are group-equal (affine-normalized, G1's
relaxed coordinates reduced mod p), since each slice adds its points in
another order than the whole-axis scan; `row_slice` is a view of the same
computation, so its words are exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rapidsnark_tpu.ops import msm as JM
from rapidsnark_tpu.ops.curve import G1P as JG1P, G2P as JG2P
from rapidsnark_tpu.ref import curve as refc
from rapidsnark_tpu_torch.ops import msm as TM
from rapidsnark_tpu_torch.ops.curve import G1P, G2P

from test_torch_msm import (_affine_window, _affine_window_jax, _points,
                            _scalar_words, _t)


def _jax_points(table, g2):
    """(rows, n, A, 8) words -> the JAX package's packed point pytree."""
    cs = [jnp.asarray(np.moveaxis(table[:, :, k], -1, 0))
          for k in range(table.shape[2])]
    if g2:
        return JM.g2_rescale_packed(((cs[0], cs[1]), (cs[2], cs[3])))
    return tuple(cs)


def _assert_group_equal(got, want_fn, g2):
    """Every window total of the port's (W, rows, L, 8) result is
    group-equal to want_fn(w, b)."""
    grp = refc.G2 if g2 else refc.G1
    for w in range(got.shape[0]):
        for b in range(got.shape[1]):
            g, e = _affine_window(got, g2, w, b), want_fn(w, b)
            assert grp.eq(g, e), f"window {w} row {b}: {g} != {e}"


@pytest.mark.parametrize("g2", [False, True])
def test_segmented_msm_group_equal(g2):
    """segment = 256 over 1024 points (8 slices of the GLV entry axis,
    the upper four on phi images): every window total is group-equal to
    the whole-axis result and to the JAX package's segmented result, and
    the scan ran once per slice per window group."""
    from rapidsnark_tpu_torch.ops import fused as TFU
    n, c, G, rows = 1024, 8, 16, 1 if g2 else 2
    _, words = _points(g2, 256, seed=6)
    table = np.broadcast_to(np.tile(words, (n // 256, 1, 1)),
                            (rows, n) + words.shape[1:]).copy()
    sc = _scalar_words(n, (rows,), seed=7)
    curve_j, curve_t = (JG2P, G2P) if g2 else (JG1P, G1P)
    tpts = TM.g2_rescale_packed(_t(table)) if g2 else _t(table)
    whole = TM.msm(curve_t, tpts, _t(sc), c, G).numpy().view(np.uint32)
    calls = []
    real = TFU.scan_cols_packed
    TFU.scan_cols_packed = lambda *a: calls.append(1) or real(*a)
    try:
        got = TM.msm(curve_t, tpts, _t(sc), c, G, segment=256)
    finally:
        TFU.scan_cols_packed = real
    got = got.numpy().view(np.uint32)
    assert len(calls) == 8 and got.shape == whole.shape
    _assert_group_equal(got, lambda w, b: _affine_window(whole, g2, w, b), g2)
    want = jax.jit(lambda p, s: JM.msm(curve_j, p, s, c, G, combine=False,
                                       segment=256))(
        _jax_points(table, g2), jnp.asarray(sc))
    _assert_group_equal(got, lambda w, b: _affine_window_jax(want, g2, w, b),
                        g2)


def test_segment_straddling_the_glv_halves():
    """768 points, segment = 512: the middle slice of the 1536-entry axis
    would hold the last 256 points and the first 256 phi images. The port
    slices within one half only (as its Prover and the JAX package's
    never ask for anything else: both fall back to segment 0 when the
    segment does not divide the point count), so such a segment raises,
    like one that is no multiple of 256 or no divisor at all; a segment
    of the whole point count (two slices, one per half) is the largest
    that runs, and is group-equal to the whole-axis result."""
    n, c, G = 768, 8, 16
    _, words = _points(False, 256, seed=8)
    table = np.tile(words, (3, 1, 1))[None]
    sc = _scalar_words(n, (1,), seed=9)
    for bad in (512, 384, 500, 1024):
        with pytest.raises(ValueError, match="segment"):
            TM.msm(G1P, _t(table), _t(sc), c, G, segment=bad)
    whole = TM.msm(G1P, _t(table), _t(sc), c, G).numpy().view(np.uint32)
    got = TM.msm(G1P, _t(table), _t(sc), c, G, segment=768)
    got = got.numpy().view(np.uint32)
    _assert_group_equal(got, lambda w, b: _affine_window(whole, False, w, b),
                        False)


@pytest.mark.parametrize("segment", [0, 256])
def test_row_slice_equals_materialized_rows(segment):
    """row_slice=(row_lo, nrows) of a bigger scalar stack gives the words
    of the msm over the copied rows."""
    n, c, G = 256, 8, 16
    _, words = _points(False, n, seed=10)
    table = np.broadcast_to(words, (2, n, 2, 8)).copy()
    stack = _scalar_words(n, (5,), seed=11)
    got = TM.msm(G1P, _t(table), _t(stack), c, G, segment=segment,
                 row_slice=(2, 2))
    want = TM.msm(G1P, _t(table), _t(stack[2:4].copy()), c, G,
                  segment=segment)
    assert got.shape[1] == 2 and torch.equal(got, want)
