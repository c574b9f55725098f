"""The seven CUDA kernels of rapidsnark_tpu_torch against their plain
PyTorch versions, on the card (marker `cuda`; each test skips when no
card is present). This file imports no JAX, so it runs on a machine
without it:

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels.py

Inputs are random canonical field elements from numpy seeds, with
(0,0) infinity columns and random signs for the scan. Tolerance: exact
words (the kernels run the plain versions' op sequences; REDC outputs
are unique whatever the limb width)."""

import numpy as np
import pytest
import torch

from rapidsnark_tpu_torch.ops import fused as TFU
from rapidsnark_tpu_torch.ops.curve import G1P, G2P, G2P_ISO
from rapidsnark_tpu_torch.ref.field import P, R_FR

CURVES = {"G1P": (G1P, 3), "G2P_ISO": (G2P_ISO, 6)}
MIXED_CURVES = {"G1P": (G1P, 3), "G2P": (G2P, 6)}


def _dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fe(mod, shape, seed, dev):
    """Random canonical elements as packed int32 words (*shape, 8)."""
    rs = np.random.RandomState(seed)
    w = rs.randint(0, 1 << 32, size=tuple(shape) + (8,), dtype=np.uint64)
    w[..., 7] %= mod >> 224          # top word below the modulus's
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("n", [1, 1000])
def test_add_kernel_matches_plain(curve, n):
    dev = _dev()
    c, L = CURVES[curve]
    p, q = _fe(P, (n, L), 1, dev), _fe(P, (n, L), 2, dev)
    got = TFU.add(c, p, q)
    want = TFU.add_plain(c, p, q)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("K", [1, 2, 256])
def test_scan_kernel_matches_plain(curve, K):
    dev = _dev()
    c, L = CURVES[curve]
    n, A = 300, L - L // 3
    acc = _fe(P, (n, L), 3, dev)
    cols = _fe(P, (K, n, A), 4, dev)
    cols[:, ::7] = 0                                   # infinity lanes
    rs = np.random.RandomState(K)
    sign = torch.from_numpy(rs.randint(0, 2, size=(K, n))
                            .astype(np.int32)).to(dev)
    got = TFU.scan_cols_packed(c, acc, cols, sign)
    want = TFU.scan_cols_plain(c, acc, cols, sign)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dif", [False, True])
def test_butterfly_kernel_matches_plain(dif):
    dev = _dev()
    lo, hi, tw = (_fe(R_FR, (3, 64), s, dev) for s in (5, 6, 7))
    got = TFU.ntt_butterfly(lo, hi, tw, dif)
    want = TFU.ntt_butterfly_plain(lo, hi, tw, dif)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("power,lo_bit,nbits,dif,pre", [
    (14, 0, 10, False, True), (14, 0, 10, True, False),
    (14, 10, 4, False, False), (14, 10, 4, True, False),
    (12, 10, 2, True, False), (12, 0, 10, False, False)])
def test_fused_pass_kernel_matches_plain(power, lo_bit, nbits, dif, pre):
    dev = _dev()
    x = _fe(R_FR, (2, 1 << power), 8, dev)
    tw = _fe(R_FR, (1 << (power - 1),), 9, dev)
    pm = _fe(R_FR, (1 << power,), 10, dev) if pre else None
    got = TFU.ntt_fused_pass(x, tw, lo_bit, nbits, dif, pm)
    want = TFU.ntt_fused_pass_plain(x, tw, lo_bit, nbits, dif, pm)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["packed", "limbs"])
@pytest.mark.parametrize("curve", sorted(MIXED_CURVES))
@pytest.mark.parametrize("n", [1, 1000])
def test_add_mixed_kernels_match_plain(curve, form, n):
    """Random canonical operands with (0,0) lanes, and lanes where the
    affine operand is +-(the projective one, z = 1)."""
    dev = _dev()
    c, L = MIXED_CURVES[curve]
    A = L - L // 3
    p, q = _fe(P, (n, L), 12, dev), _fe(P, (n, A), 13, dev)
    q[::7] = 0                                         # infinity lanes
    one = torch.tensor(np.array(
        [(((1 << 256) % P) >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
        dtype=np.uint32).view(np.int32), device=dev)
    p[2::5, A:] = 0
    p[2::5, A] = one                                   # z = 1
    p[2::5, :A] = q[2::5]                              # q = p (doubling)
    if form == "limbs":
        qq = q.to(torch.int64) & 0xFFFFFFFF
        ql = torch.stack([qq & 0xFFFF, qq >> 16], dim=-1).reshape(
            n, A, 16).to(torch.int32).contiguous()
        got = TFU.add_mixed(c, p, ql)
        want = TFU.add_mixed_plain(c, p, ql)
    else:
        got = TFU.add_mixed_packed(c, p, q)
        want = TFU.add_mixed_packed_plain(c, p, q)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dif", [False, True])
@pytest.mark.parametrize("power,batch", [(7, 1), (7, 3), (12, 2), (14, 3)])
def test_tail_kernel_matches_plain_and_fused_pass(power, batch, dif):
    dev = _dev()
    x = _fe(R_FR, (batch, 1 << power), 14, dev)
    tw = _fe(R_FR, (1 << (power - 1),), 15, dev)
    got = TFU.ntt_tail(x, tw, dif)
    want = TFU.ntt_tail_plain(x, tw, dif)
    same = TFU.ntt_fused_pass(x, tw, 0, 7, dif)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, same)


@pytest.mark.cuda
def test_segmented_msm_on_card_matches_cpu():
    """msm(segment=, row_slice=) through the kernels on the card gives
    the words of the plain path on the CPU (stable sorts and word-exact
    kernels on both sides), with one scan launch per slice."""
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    from rapidsnark_tpu_torch.ops import msm as TM
    n, c, G = 512, 8, 16
    pts = _fe(P, (2, n, 2), 16, "cpu")
    pts[:, ::9] = 0                                    # infinity entries
    stack = _fe(1 << 253, (4, n), 17, "cpu")
    want = TM.msm(G1P, pts, stack, c, G, segment=256, row_slice=(1, 2))
    D.reset_counts()
    got = TM.msm(G1P, pts.to(dev), stack.to(dev), c, G, segment=256,
                 row_slice=(1, 2))
    torch.cuda.synchronize()
    assert D.counts["scan_cols_packed"] == 4
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_wrappers_count_launches():
    dev = _dev()
    from rapidsnark_tpu_torch import device as D
    D.reset_counts()
    p = _fe(P, (4, 3), 11, dev)
    TFU.add(G1P, p, p)
    TFU.add_plain(G1P, p, p)
    assert D.counts["add"] == 1
