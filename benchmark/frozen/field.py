# Frozen copy of rapidsnark_tpu_torch/ops/field.py at commit 6caa3f5 for the benchmark's yardstick.
# Changed: imports; the relaxed [0, 2p] ops, which nothing here calls, left out.
"""Multi-limb Montgomery field arithmetic on torch tensors (BN254 Fq, Fr).

The plain counterpart of `rapidsnark_tpu/ops/field.py`: a batch of field
elements is ONE int64 tensor of shape (16, *batch) — 16 little-endian
16-bit limbs on the leading axis. int64 because CPU torch has no uint32
add or shift; the limbs still hold 16-bit values, so every result is
word-identical to the JAX package's uint32 limbs. Montgomery radix
R = 2^256 whatever the limb width, which is why the CUDA kernels
(csrc/field.cuh, 8 x 32-bit limbs) agree word for word too.

Device tensors travel PACKED and element-major: (*batch, 8) int32
holding the bits of the u32 words `lo | hi << 16` — the zkey/wtns
payload layout, and the layout every CUDA kernel reads. `pack` /
`unpack` convert.

Relaxed domain (the MSM's G1 group law): values are any representative
in [0, 2p]; muls skip the final conditional subtraction and linear ops
re-enter [0, 2p] with one conditional subtraction of 2p. The bound
algebra is the JAX package's (asserted at the bottom of this module).
"""

from __future__ import annotations

import torch

from .ref_field import P as _P, R_FR as _R

NLIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1

Elem = torch.Tensor  # (16, *batch) int64


def pack_limb_rows(a: torch.Tensor) -> torch.Tensor:
    """(16, ...) 16-bit limbs -> (8, ...) u32 word values (int64)."""
    return a[0::2] | (a[1::2] << 16)


def unpack_limb_rows(w: torch.Tensor) -> torch.Tensor:
    """(8, ...) u32 word values -> (16, ...) int64 limbs."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & MASK, w >> 16], dim=1).reshape(
        (2 * w.shape[0],) + tuple(w.shape[1:]))


def to_i32(w: torch.Tensor) -> torch.Tensor:
    """u32 word values held in int64 -> the same bits as int32."""
    return (w - ((w >> 31) << 32)).to(torch.int32)


def pack(a: Elem) -> torch.Tensor:
    """(16, *b) int64 limbs -> (*b, 8) int32 packed words."""
    return to_i32(pack_limb_rows(a)).movedim(0, -1).contiguous()


def unpack(w: torch.Tensor) -> Elem:
    """(*b, 8) int32 packed words -> (16, *b) int64 limbs."""
    return unpack_limb_rows(w.movedim(-1, 0))


def _ripple(s: torch.Tensor):
    """Carry-resolve limbs (any int64 values, negative included: the
    arithmetic shift propagates borrows), limb by limb: a fixed op count
    and no host sync. Returns (16-bit limbs mod 2^(16*L), signed carry
    out of the top limb)."""
    out = []
    carry = torch.zeros_like(s[0])
    for i in range(s.shape[0]):
        t = s[i] + carry
        out.append(t & MASK)
        carry = t >> LIMB_BITS
    return torch.stack(out), carry


def _bshape(x) -> tuple:
    return tuple(x.shape[1:])


class FieldOps:
    """Montgomery arithmetic mod `modulus`, R = 2^256, on int64 limbs."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.p_int = [(modulus >> (LIMB_BITS * i)) & MASK
                      for i in range(NLIMBS)]
        self.n0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.r1 = (1 << 256) % modulus
        self.r2 = (1 << 512) % modulus
        self._cache = {}

    # -- constants -----------------------------------------------------------
    def _limbs(self, value: int, device) -> torch.Tensor:
        """(16,) int64 limb vector of a plain non-negative int, cached per
        device (no host->device copy per call)."""
        key = (value, str(device))
        t = self._cache.get(key)
        if t is None:
            t = torch.tensor([(value >> (LIMB_BITS * i)) & MASK
                              for i in range(NLIMBS)], dtype=torch.int64,
                             device=device)
            self._cache[key] = t
        return t

    def _col(self, value: int, like: torch.Tensor) -> torch.Tensor:
        """Limb constant shaped to broadcast against `like` (16, *b)."""
        return self._limbs(value, like.device).reshape(
            (NLIMBS,) + (1,) * (like.dim() - 1))

    def const(self, value: int, shape=(), device="cpu") -> Elem:
        value %= self.modulus
        return self._limbs(value, device).reshape(
            (NLIMBS,) + (1,) * len(shape)).expand((NLIMBS,) + tuple(shape))

    def zero(self, shape=(), device="cpu") -> Elem:
        return torch.zeros((NLIMBS,) + tuple(shape), dtype=torch.int64,
                           device=device)

    def one_mont(self, shape=(), device="cpu") -> Elem:
        return self.const(self.r1, shape, device)

    # -- selection / predicates --------------------------------------------
    @staticmethod
    def select(mask, a: Elem, b: Elem) -> Elem:
        """mask ? a : b; mask is batch-shaped (broadcast over limbs)."""
        return torch.where(mask[None], a, b)

    @staticmethod
    def is_zero(a: Elem):
        return torch.all(a == 0, dim=0)

    # -- modular ring ops ----------------------------------------------------
    def _cond_sub(self, s: Elem, value: int) -> Elem:
        """s - value if s >= value else s (s < 2^256, canonical limbs)."""
        d, c = _ripple(s - self._col(value, s))
        return torch.where((c >= 0)[None], d, s)

    def _cond_sub_p(self, s: Elem) -> Elem:
        return self._cond_sub(s, self.modulus)

    def add(self, a: Elem, b: Elem) -> Elem:
        return self._cond_sub_p(_ripple(a + b)[0])

    def sub(self, a: Elem, b: Elem) -> Elem:
        d, c = _ripple(a - b)
        e = _ripple(d + self._col(self.modulus, d))[0]
        return torch.where((c >= 0)[None], d, e)

    def neg(self, a: Elem) -> Elem:
        return self.sub(torch.zeros_like(a), a)

    def double(self, a: Elem) -> Elem:
        return self.add(a, a)

    def canon(self, a: Elem) -> Elem:
        """Any representative < 3p (the relaxed domain's included) ->
        canonical."""
        return self._cond_sub_p(self._cond_sub_p(a))

    def add_lazy(self, a: Elem, b: Elem) -> Elem:
        """a+b with canonical limbs, value possibly in [p, 2p): a `mul`
        input only."""
        return _ripple(a + b)[0]

    # -- Montgomery multiply -------------------------------------------------
    def mul(self, a: Elem, b: Elem, cond_sub: bool = True) -> Elem:
        """a*b*R^-1 mod p (canonical out). cond_sub=False returns the
        unreduced REDC output T = (a*b + m*p) / R, which is unique (m is
        the one value in [0, R) that makes the division exact) — so any
        limb width computes the same words.

        Product columns by 16 row adds, then 16 word-by-word REDC rounds
        (word 2^16): bounded temporaries (32 columns per lane); column
        values stay < 2^41 in int64."""
        a, b = torch.broadcast_tensors(a, b)
        t = torch.zeros((2 * NLIMBS,) + _bshape(a), dtype=torch.int64,
                        device=a.device)
        for i in range(NLIMBS):
            t[i:i + NLIMBS] += a[i] * b
        pcol = self._col(self.modulus, a)
        for i in range(NLIMBS):
            m = ((t[i] & MASK) * self.n0inv) & MASK
            t[i:i + NLIMBS] += m * pcol
            t[i + 1] += t[i] >> LIMB_BITS
        out = _ripple(t[NLIMBS:])[0]
        return self._cond_sub_p(out) if cond_sub else out

    def mul_many(self, pairs, cond_sub: bool = True):
        """k independent products as ONE batched mul (stacked on a new
        axis 1)."""
        a = torch.stack([torch.broadcast_tensors(x, y)[0] for x, y in pairs],
                        dim=1)
        b = torch.stack([torch.broadcast_tensors(x, y)[1] for x, y in pairs],
                        dim=1)
        out = self.mul(a, b, cond_sub=cond_sub)
        return [out[:, k] for k in range(len(pairs))]

    # -- domain conversions --------------------------------------------------
    def from_mont(self, a: Elem) -> Elem:
        return self.mul(a, self.const(1, _bshape(a), a.device))

    def to_mont(self, a: Elem) -> Elem:
        return self.mul(a, self.const(self.r2, _bshape(a), a.device))

    def reduce_wide(self, cols: Elem) -> Elem:
        """Reduce a deferred-carry accumulator of K >= 18 columns (each
        < 2^31) to a canonical element: value = lo + hi*2^256, lo mod p
        via a Montgomery round trip, hi*2^256 mod p = to_mont(hi)."""
        full, _ = _ripple(cols)
        lo = full[:NLIMBS]
        hi = torch.zeros_like(lo)
        nhi = full.shape[0] - NLIMBS
        hi[:nhi] = full[NLIMBS:]
        lo_red = self.from_mont(self.to_mont(lo))
        hi_red = self.to_mont(hi)
        return self.add(lo_red, hi_red)


FQ = FieldOps(_P)
FR = FieldOps(_R)
