"""Radix-2 NTT over BN254 Fr on packed torch tensors.

Counterpart of `rapidsnark_tpu/ops/ntt.py`, with the same tables and the
same convention (fft(a)[i] = sum_k a[k] w^(ik), w = fr_w(log2 N), the
snarkjs/ffjavascript root chain; twiddles in Montgomery form). Vectors
are packed element-major: (*batch, N, 8) int32.

Dispatch: a transform runs as fused passes (ops/fused.ntt_fused_pass;
the bottom pass carries the 10 lowest layers, every further pass 5
more), so up to 2^10 points it is one launch a direction, one block a
polynomial holding every element in shared memory. The JAX package runs
its transforms below 2^12 points one ntt_butterfly layer at a time,
each layer a launch and its relayout, which on the card is launch
latency and glue. With RSTPU_NTT_FUSE=0 (config.ntt_fuse) a transform
runs per stage at every size instead: ops/fused.ntt_tail for the layers
on bits 0-6 from 2^12 points, one ops/fused.ntt_butterfly layer for
every other bit. The odd-coset map is the gather-free DIF -> (1/N *
eta^k at bit-reversed positions) -> DIT form, with the multiply folded
into the DIT's first fused pass (per stage, one ops/front.fr_pointwise;
it also scales the inverse DFT by 1/N). NTTPlan builds its tables on
the device as products of two short host lists of powers (powers_mont),
not by a host loop per element.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import config, device as D
from ..ref.field import R_FR, fr_w
from . import front, fused

TAIL_MIN_BITS = 12      # the per-stage path has a tail from N = 2^12
BOTTOM_BITS = 10        # layers in the first (contiguous) pass
UPPER_BITS = 5          # layers per further pass


_POW_LANES = 1 << 20    # Montgomery products per step of powers_mont


def ints_to_words(vals) -> np.ndarray:
    """Python ints (< 2^256) -> (n, 8) uint32 little-endian words."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), 8).copy()


def _host_powers(root: int, count: int, scale: int = 1) -> list:
    """[mont(scale * root^k) for k < count] as Python ints."""
    vals, cur = [], scale % R_FR
    for _ in range(count):
        vals.append(cur * (1 << 256) % R_FR)
        cur = cur * root % R_FR
    return vals


def _words_t(vals, device) -> torch.Tensor:
    return torch.from_numpy(ints_to_words(vals).view(np.int32)).to(device)


def powers_mont(root: int, count: int, scale: int = 1,
                device="cpu") -> torch.Tensor:
    """[mont(scale * root^k) for k < count] as (count, 8) int32 packed
    words, built on `device` in two levels: host lists of m ~ sqrt(count)
    powers, root^j and scale * root^(i*m), then their outer product as Fr
    Montgomery products (entry i*m + j) by ops/front.fr_pointwise (the
    row of root^j broadcast over the rows of scale * root^(i*m), repeated
    m times), _POW_LANES at a time. Canonical Montgomery residues are
    unique, so the words are the host loop's."""
    m = 1 << (((max(count, 1) - 1).bit_length() + 1) // 2)
    rows = -(-count // m)
    lo = _words_t(_host_powers(root, m), device)                 # (m, 8)
    hi = _words_t(_host_powers(pow(root, m, R_FR), rows, scale), device)
    out = torch.empty((rows * m, 8), dtype=torch.int32, device=device)
    step = max(1, _POW_LANES // m)
    for r in range(0, rows, step):
        blk = hi[r:r + step, None, :].expand(-1, m, 8).contiguous()
        out[r * m:(r + blk.shape[0]) * m] = front.fr_pointwise(
            "mul", blk, lo).reshape(-1, 8)
    return out[:count]


def bitrev_indices(n: int, device="cpu") -> torch.Tensor:
    """The bit-reversal permutation of n = 2^k positions (int64)."""
    bits = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


TABLES = ("fwd_tw", "inv_tw", "ninv", "bitrev", "coset", "coset_ninv_br")


class NTTPlan:
    """Tables for domain size N = 2^power, built on `device` (resolved as
    every entry point does: the card unless the caller asks for the CPU)
    as packed (rows, 8) int32 Montgomery words: fwd_tw / inv_tw (N/2
    twiddles), ninv (1/N), bitrev (int64 positions), coset (eta^k),
    coset_ninv_br (1/N * eta^k at bit-reversed positions, one device
    index of the natural table). `keep` names the tables to build (default
    all); the words equal the JAX package's NTTPlan."""

    def __init__(self, power: int, device=None, keep=None):
        self.power = power
        self.n = 1 << power
        self.device = D.resolve(device)
        dev = self.device
        w = fr_w(power)
        half = max(self.n // 2, 1)
        self.eta = fr_w(power + 1)
        ninv = pow(self.n, -1, R_FR)
        want = set(TABLES if keep is None else keep)
        t: Dict[str, torch.Tensor] = {}
        if "fwd_tw" in want:
            t["fwd_tw"] = powers_mont(w, half, device=dev)
        if "inv_tw" in want:
            t["inv_tw"] = powers_mont(pow(w, -1, R_FR), half, device=dev)
        if "ninv" in want:
            t["ninv"] = _words_t([ninv * (1 << 256) % R_FR], dev)[0]
        if want & {"bitrev", "coset_ninv_br"}:
            t["bitrev"] = bitrev_indices(self.n, dev)
        if "coset" in want:
            t["coset"] = powers_mont(self.eta, self.n, device=dev)
        if "coset_ninv_br" in want:
            t["coset_ninv_br"] = powers_mont(
                self.eta, self.n, ninv, device=dev)[t["bitrev"]]
        self._tables = {k: v for k, v in t.items() if k in want}

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The tables as tensors on the plan's device (words as int32
        bits)."""
        return dict(self._tables)

    def arrays(self) -> Dict[str, np.ndarray]:
        """Host copies: (rows, 8) uint32 words, bitrev int64."""
        return {k: v.cpu().numpy() if k == "bitrev"
                else v.cpu().numpy().view(np.uint32)
                for k, v in self._tables.items()}


def _passes(logn: int):
    """(lo_bit, nbits) of the fused passes, bottom-up."""
    out = [(0, min(BOTTOM_BITS, logn))]
    lo = out[0][1]
    while lo < logn:
        k = min(UPPER_BITS, logn - lo)
        out.append((lo, k))
        lo += k
    return out


def _tail_stages(n: int) -> int:
    """Layers of the per-stage path that ops/fused.ntt_tail carries."""
    return fused.TAIL_BITS if n >= (1 << TAIL_MIN_BITS) else 0


def _apply_stage(x, tw, bit: int, dif: bool):
    """One layer (half size 2^bit) through ops/fused.ntt_butterfly:
    partners pair by a static reshape, never a gather."""
    bsz, n = x.shape[0], x.shape[1]
    h = 1 << bit
    xv = x.reshape(bsz, n // (2 * h), 2, h, 8)
    lo = xv[:, :, 0].contiguous()
    hi = xv[:, :, 1].contiguous()
    twl = fused.stage_twiddles(tw, n, bit).expand(lo.shape).contiguous()
    lo, hi = fused.ntt_butterfly(lo, hi, twl, dif=dif)
    return torch.stack([lo, hi], dim=2).reshape(bsz, n, 8)


def _mul_rows(x, m):
    """x (B, n, 8) * m (n, 8), elementwise in Fr."""
    return front.fr_pointwise("mul", x.contiguous(), m)


def _stages_dit(x, tw, pre_mul=None):
    """Bit-reversed (B, n, 8) -> natural order; pre_mul (n, 8) applied
    first."""
    n = x.shape[1]
    logn = n.bit_length() - 1
    if config.ntt_fuse(n):
        for i, (lo, k) in enumerate(_passes(logn)):
            x = fused.ntt_fused_pass(x, tw, lo, k, dif=False,
                                     pre_mul=pre_mul if i == 0 else None)
        return x
    if pre_mul is not None:
        x = _mul_rows(x, pre_mul)
    k0 = _tail_stages(n)
    if k0:
        x = fused.ntt_tail(x, tw, dif=False)
    for s in range(k0, logn):
        x = _apply_stage(x, tw, s, dif=False)
    return x


def _stages_dif(x, tw):
    """Natural (B, n, 8) -> bit-reversed order; with inverse twiddles the
    unscaled inverse DFT."""
    n = x.shape[1]
    logn = n.bit_length() - 1
    if config.ntt_fuse(n):
        for lo, k in reversed(_passes(logn)):
            x = fused.ntt_fused_pass(x, tw, lo, k, dif=True)
        return x
    k0 = _tail_stages(n)
    for s in reversed(range(k0, logn)):
        x = _apply_stage(x, tw, s, dif=True)
    if k0:
        x = fused.ntt_tail(x, tw, dif=True)
    return x


def _flat(x):
    return x.reshape((-1,) + tuple(x.shape[-2:])).contiguous()


def ntt(x, arrays, inverse: bool = False):
    """DFT / inverse DFT of packed stored values x: (*b, N, 8)."""
    shape = x.shape
    v = _flat(x)[:, arrays["bitrev"]].contiguous()
    v = _stages_dit(v, arrays["inv_tw"] if inverse else arrays["fwd_tw"])
    if inverse:
        v = front.fr_pointwise("mul", v, arrays["ninv"])
    return v.reshape(shape)


def to_odd_coset(x, arrays):
    """ifft -> multiply element k by eta^k -> fft (groth16.cpp:101-155):
    evaluations on H -> evaluations on the odd coset. x: (*b, N, 8).
    Gather-free: DIF (unscaled inverse, natural -> bit-reversed), the
    coset_ninv_br multiply, DIT (bit-reversed -> natural)."""
    shape = x.shape
    v = _stages_dif(_flat(x), arrays["inv_tw"])
    v = _stages_dit(v, arrays["fwd_tw"], pre_mul=arrays["coset_ninv_br"])
    return v.reshape(shape)
