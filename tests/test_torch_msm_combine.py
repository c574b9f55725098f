"""The port's device window combine (`msm(combine=True)`, `_combine_windows`
of rapidsnark_tpu_torch/ops/msm.py) vs the JAX package's msm with the same
arguments, the oracle MSM and the host combine, on the same numpy inputs.

Tolerance: results are group-equal (affine-normalized, G1's relaxed
coordinates reduced mod p): projective words depend on the order of the
adds."""

import numpy as np
import pytest
import torch

from rapidsnark_tpu.ref import curve as refc
from rapidsnark_tpu_torch.ops import msm as TM
from rapidsnark_tpu_torch.ops.curve import G1P, G2P
from rapidsnark_tpu_torch.ref.field import P
from rapidsnark_tpu_torch.utils.hostcurve import G1H, G2H

from test_torch_msm import _affine_point, _check_combined_point, _points, _t

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


@pytest.mark.parametrize("g2", [False, True])
def test_msm_combined_point_equals_jax(g2):
    """msm(combine=True) with GLV: one point per row, group-equal to the
    JAX package's msm with the same arguments and to the oracle MSM."""
    _check_combined_point(g2, glv=True)


def test_combine_windows_equals_host_combine():
    """_combine_windows on a stack of points standing for window totals
    (z = 1, an infinity among them) equals the host's Horner combine of
    the same points, on G1 and on G2's own twist (the ladder rides the
    iso-twist inside)."""
    nwin, c = 6, 5
    one = np.array([(((1 << 256) % P) >> (32 * i)) & 0xFFFFFFFF
                    for i in range(8)], np.uint32)
    for g2 in (False, True):
        pts, words = _points(g2, nwin, seed=14)          # pts[2] is None
        z = np.zeros((nwin, 2 if g2 else 1, 8), np.uint32)
        z[:, 0] = one
        z[2] = 0                                         # (0, y, 0)
        words = words.copy()
        words[2, (2 if g2 else 1)] = one                 # y = 1
        wpts = _t(np.concatenate([words, z], axis=1)[:, None])
        curve, H = (G2P, G2H) if g2 else (G1P, G1H)
        tot = TM._combine_windows(curve, wpts, nwin, c)
        assert tot.shape == (1, 6 if g2 else 3, 8)
        host = H.combine_windows([H.from_affine(p) for p in pts], c)
        grp = refc.G2 if g2 else refc.G1
        assert grp.eq(_affine_point(tot.numpy().view(np.uint32), g2, 0),
                      H.to_affine(host))
