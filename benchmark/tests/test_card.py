"""On the card: the input maker's frozen kernels agree with their plain
versions, and its key at 2^10 equals the one it makes on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.mark.cuda
def test_key_on_card_equals_key_on_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import keygen
    from benchmark.circuits import sqchain
    coo = sqchain.coo(3, 300)
    a = keygen.make_key(coo, "card:1", "cuda", chunk=1 << 8)
    b = keygen.make_key(coo, "card:1", "cpu")
    for nm in ("points_a", "points_b1", "points_b2", "points_c", "points_h",
               "ic", "coef_val"):
        assert np.array_equal(getattr(a, nm), getattr(b, nm)), nm


@pytest.mark.cuda
def test_witness_on_card_equals_witness_on_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.circuits import sqchain
    cpu = torch.Generator("cpu")
    cpu.manual_seed(4)
    gw = torch.Generator("cuda")
    gw.manual_seed(4)
    a = sqchain.witness(5, 40, gw, "cuda")
    # the card's generator draws other starts: chain the card's starts on
    # the CPU and compare the rest
    starts = a[2::41][:5]
    assert starts.shape == (5, 8)
    assert np.array_equal(sqchain.chain(5, 40, starts), a)
