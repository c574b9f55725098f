"""The port's MSM without the GLV split (`msm(glv=False)` of
rapidsnark_tpu_torch/ops/msm.py), whole-axis and segmented, vs the JAX
package's msm with the same arguments, on the same numpy inputs.

Tolerance: results are group-equal (affine-normalized, G1's relaxed
coordinates reduced mod p): projective words depend on the order of the
adds."""

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

from test_torch_msm import (_affine_point, _affine_point_jax,
                            _check_combined_point, _jax_table, _points,
                            _scalar_words, _t)

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def test_whole_axis_msm_without_glv_equals_jax():
    """glv=False over the whole axis on G1 (32 windows of the table
    itself, no phi image): the combined point equals the JAX package's
    and the oracle's."""
    _check_combined_point(False, glv=False)


@pytest.mark.parametrize("g2", [False, True])
def test_segmented_msm_without_glv_equals_jax(g2):
    """glv=False, segment = 256 over 512 points (two slices of the table
    itself, 32 windows in two groups), combine=True: group-equal to the
    port's whole-axis result and to the JAX package's msm with the same
    arguments."""
    n, c, G, rows = 512, 8, 16, 1
    _, words = _points(g2, 256, seed=12)
    table = np.broadcast_to(np.tile(words, (n // 256, 1, 1)),
                            (rows, n) + words.shape[1:]).copy()
    sc = _scalar_words(n, (rows,), seed=13)
    curve_j, curve_t = (JG2P, G2P) if g2 else (JG1P, G1P)
    tpts = TM.g2_rescale_packed(_t(table)) if g2 else _t(table)
    got = TM.msm(curve_t, tpts, _t(sc), c, G, combine=True, segment=256,
                 glv=False).numpy().view(np.uint32)
    whole = TM.msm(curve_t, tpts, _t(sc), c, G, combine=True,
                   glv=False).numpy().view(np.uint32)
    want = jax.jit(lambda p, s: JM.msm(curve_j, p, s, c, G, combine=True,
                                       segment=256, glv=False))(
        _jax_table(table, g2), jnp.asarray(sc))
    grp = refc.G2 if g2 else refc.G1
    g = _affine_point(got, g2, 0)
    assert grp.eq(g, _affine_point(whole, g2, 0))
    assert grp.eq(g, _affine_point_jax(want, g2, 0))
