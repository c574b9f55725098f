"""The port's NTT tables, built on the device (ops/ntt.powers_mont,
NTTPlan), against the host formula and the JAX package's NTTPlan, on the
CPU. Tolerance: exact words (canonical Montgomery residues are unique)."""

import numpy as np
import pytest
import torch

from rapidsnark_tpu.ops import ntt as JN
from rapidsnark_tpu.ref.field import R_FR, fr_w
from rapidsnark_tpu_torch.ops import ntt as TN

from test_torch_field import words_of

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def _host_formula(root, count, scale):
    """[mont(scale * root^k) for k < count] by a loop, as (count, 8) u32."""
    out, cur = [], scale % R_FR
    for _ in range(count):
        v = cur * (1 << 256) % R_FR
        out.append([(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)])
        cur = cur * root % R_FR
    return np.array(out, dtype=np.uint32).reshape(count, 8)


@pytest.mark.parametrize("scale", [1, 0x1234567890ABCDEF ** 3])
@pytest.mark.parametrize("count", [1, 2, 3, 1000, 4096])
def test_powers_match_host_formula(count, scale):
    root = fr_w(13)
    got = TN.powers_mont(root, count, scale, device="cpu")
    assert got.shape == (count, 8) and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32),
                          _host_formula(root, count, scale))


@pytest.mark.parametrize("power", range(1, 13))
def test_plan_matches_jax_plan(power):
    jp = JN.NTTPlan(power).arrays()
    tp = TN.NTTPlan(power, "cpu")
    ta = tp.arrays()
    assert sorted(ta) == sorted(TN.TABLES)
    for k in ("fwd_tw", "inv_tw", "coset", "coset_ninv_br"):
        assert np.array_equal(words_of(jp[k]), ta[k]), k
    assert np.array_equal(words_of(jp["ninv"]), ta["ninv"])
    assert np.array_equal(jp["bitrev"].astype(np.int64), ta["bitrev"])
    assert tp.eta == fr_w(power + 1)


def test_plan_keeps_only_what_is_asked():
    """The Prover's tables: the two twiddle sets and the coset factors at
    bit-reversed positions, all on the plan's device."""
    keep = ("fwd_tw", "inv_tw", "coset_ninv_br")
    part = TN.NTTPlan(8, "cpu", keep=keep).tensors()
    full = TN.NTTPlan(8, "cpu").tensors()
    assert sorted(part) == sorted(keep)
    for k in keep:
        assert part[k].device.type == "cpu" and torch.equal(part[k], full[k])
    assert sorted(TN.NTTPlan(8, "cpu", keep=("ninv",)).tensors()) == ["ninv"]


def test_plan_device_is_resolved():
    """NTTPlan defaults to the card, like every entry point."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TN.NTTPlan(4)
