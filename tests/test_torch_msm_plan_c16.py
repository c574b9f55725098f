"""The MSM at the window bits config.msm_plan takes on the H100 (c = 16:
8 windows of 2^15 buckets), on the CPU against the JAX package's msm.
Its own file because a plain msm at c = 16 takes minutes on the CPU
(the buckets' adds); tests/test_torch_msm_plan.py holds the plan.
Tolerance: window totals group-equal (G1's relaxed coordinates reduced
mod p, affine-normalised), the combined point equal to the oracle's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapidsnark_tpu.ops import msm as JM
from rapidsnark_tpu.ops.curve import G1P as JG1P, G2P as JG2P
from rapidsnark_tpu.ref import curve as refc
from rapidsnark_tpu_torch import config as C
from rapidsnark_tpu_torch.ops import msm as MSM
from rapidsnark_tpu_torch.ops.curve import G1P, G2P
from rapidsnark_tpu_torch.utils.hostcurve import G1H, G2H

import test_torch_msm as TMSM

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


@pytest.mark.parametrize("g2", [False, True])
def test_msm_at_the_plans_c(g2):
    """The plan takes c = 16 (8 windows of 2^15 buckets) from 2^18 points
    on: one msm at the 2^24 plan's c and G on 256 points (G1 one row, G2
    on the iso-twist), every window total group-equal to the JAX
    package's msm after reduction mod p and affine normalisation, and
    the host combine of the windows equal to the oracle MSM."""
    plan = C.msm_plan(1 << 24)
    c, G, n = plan.c, plan.G, 256
    assert c >= 15
    pts, words = TMSM._points(g2, n, seed=11)
    sc = TMSM._scalar_words(n, (1,), seed=12)
    table = words[None].copy()
    if g2:
        cs = [jnp.asarray(np.moveaxis(table[:, :, k], -1, 0))
              for k in range(4)]
        jpts = JM.g2_rescale_packed(((cs[0], cs[1]), (cs[2], cs[3])))
        tpts = MSM.g2_rescale_packed(TMSM._t(table))
    else:
        jpts = tuple(jnp.asarray(np.moveaxis(table[:, :, k], -1, 0))
                     for k in range(2))
        tpts = TMSM._t(table)
    curve_j, curve_t = (JG2P, G2P) if g2 else (JG1P, G1P)
    want = jax.jit(lambda p, s: JM.msm(curve_j, p, s, c, G, combine=False))(
        jpts, jnp.asarray(sc))
    got = MSM.msm(curve_t, tpts, TMSM._t(sc), c, G).numpy().view(np.uint32)
    nwin = got.shape[0]
    assert nwin == -(-128 // c)
    grp = refc.G2 if g2 else refc.G1
    for w in range(nwin):
        g = TMSM._affine_window(got, g2, w, 0)
        e = TMSM._affine_window_jax(want, g2, w, 0)
        assert (g is None and e is None) or grp.eq(g, e)
    H = G2H if g2 else G1H
    tot = H.combine_windows([H.from_affine(TMSM._affine_window(got, g2, w, 0))
                             for w in range(nwin)], c)
    ks = [int.from_bytes(sc[0, i].tobytes(), "little") for i in range(n)]
    assert grp.eq(H.to_affine(tot), grp.msm(pts, ks))
