"""GLV endomorphism scalar decomposition for BN254 G1 and G2 (torch).

Counterpart of `rapidsnark_tpu/ops/glv.py`: k = k1 + k2*lam (mod r) with
|ki| < 2^127 by Babai round-off against a Gauss-reduced lattice basis,
so an n-point 254-bit MSM becomes a 2n-point 128-bit MSM over the
virtual table [P, phi(P)], phi(x, y) = (beta*x, y). The rounding
products run as exact 16-bit-limb convolutions in int64: the plain
version, which ops/msm.glv_digits runs on CPU tensors; on the card its
kernel (csrc/msm.cu) computes the same integers in 32-bit words.
"""

from __future__ import annotations

import os
import random

import torch

from ..ref.field import P as _P, R_FR as _R
from . import field as FF

MASK = 0xFFFF
GLV_BITS = 128

BETA_G1 = 2203960485148121921418603742825762020974279258880205651966
LAM_G1 = 4407920970296243842393367215006156084916469457145843978461
BETA_G2 = BETA_G1            # same x-scaling acts as the OTHER root on
LAM_G2 = _R - 1 - LAM_G1     # the twist (sum of roots = -1 mod r)

_S = 272  # fixed-point shift of the Babai rounding constants (17 limbs)


def _gauss_reduce(lam: int):
    """Shortest basis of {(a, b): a + b*lam = 0 mod r} (Gauss/Lagrange)."""
    v1, v2 = (_R, 0), (-lam, 1)

    def n2(v):
        return v[0] * v[0] + v[1] * v[1]

    if n2(v1) < n2(v2):
        v1, v2 = v2, v1
    while True:
        d = v1[0] * v2[0] + v1[1] * v2[1]
        m = ((2 * d + n2(v2)) // (2 * n2(v2)) if d >= 0
             else -((-2 * d + n2(v2)) // (2 * n2(v2))))
        v1 = (v1[0] - m * v2[0], v1[1] - m * v2[1])
        if n2(v1) >= n2(v2):
            break
        v1, v2 = v2, v1
    return v2, v1


class GLVParams:
    """Per-group decomposition constants (plain ints)."""

    def __init__(self, lam: int, beta: int):
        self.lam = lam
        self.beta = beta
        self.beta_mont = beta * (1 << 256) % _P
        v1, v2 = _gauss_reduce(lam)
        det = v1[0] * v2[1] - v1[1] * v2[0]
        assert abs(det) == _R
        self.v1, self.v2 = v1, v2
        num1, num2 = v2[1], -v1[1]
        self.s1 = 1 if num1 * det > 0 else -1
        self.s2 = 1 if num2 * det > 0 else -1
        self.g1 = (abs(num1) << _S) // abs(det)
        self.g2 = (abs(num2) << _S) // abs(det)
        M176 = 1 << 176
        self.t1a = (-self.s1 * v1[0]) % M176
        self.t2a = (-self.s2 * v2[0]) % M176
        self.t1b = (-self.s1 * v1[1]) % M176
        self.t2b = (-self.s2 * v2[1]) % M176
        # exact worst-case |ki| bound (see the JAX module)
        slack_num, slack_den = 1 << (_S - 1), 1 << _S
        eps_num, eps_den = 1 << 254, 1 << _S
        bnds = []
        for comp in (0, 1):
            m = abs(v1[comp]) + abs(v2[comp])
            bnds.append((m * slack_num * eps_den + m * eps_num * slack_den)
                        // (slack_den * eps_den) + 1)
        self.bound = max(bnds)
        assert self.bound < (1 << 127)
        for c in range(2, 17):
            nwin = -(-GLV_BITS // c)
            assert (self.bound >> ((nwin - 1) * c)) + 1 < (1 << (c - 1)), c


G1_PARAMS = GLVParams(LAM_G1, BETA_G1)
G2_PARAMS = GLVParams(LAM_G2, BETA_G2)


def edge_scalars(params: GLVParams, seed: int = 0) -> list:
    """Scalars < r at the edges of the decomposition, where a slip in its
    limb arithmetic would show and random scalars almost never go: 0, 1,
    r - 1 and their neighbours, powers of two around 2^127 and 2^253,
    small multiples of lam, both sides of the rounding steps of c1 and
    c2 (k g next to j 2^272 - 2^271), and a + b lam for a, b at 0, +-1,
    +-2^125 and +-bound (|k1|, |k2| next to their largest)."""
    rng = random.Random(seed)
    out = [0, 1, 2, 3, _R - 1, _R - 2, _R // 2, _R // 2 + 1,
           (1 << 127) - 1, 1 << 127, (1 << 128) - 1, 1 << 128,
           (1 << 253) - 1, 1 << 253]
    out += [k * params.lam % _R for k in (1, 2, 3, -1, -2)]
    out += [(params.lam + d) % _R for d in (-1, 1)]
    for g in (params.g1, params.g2):
        for _ in range(4):
            j = rng.randrange(1, (_R * g) >> _S)
            k0 = -(-((j << _S) - (1 << (_S - 1))) // g)
            out += [k for k in (k0 - 1, k0, k0 + 1) if 0 <= k < _R]
    big = params.bound
    for a in (0, 1, -1, 1 << 125, -(1 << 125), big, -big):
        for b in (0, 1, -1, 1 << 125, -(1 << 125), big, -big):
            out.append((a + b * params.lam) % _R)
    return out


def params_for(curve) -> GLVParams:
    from .curve import is_g2
    return G2_PARAMS if is_g2(curve) else G1_PARAMS


def enabled() -> bool:
    """Whether ops/msm.msm splits scalars by GLV when its caller does not
    say: on unless RSTPU_GLV=0. Read at every call (the JAX package
    caches its first reading)."""
    return os.environ.get("RSTPU_GLV", "1") != "0"


def _const_limbs(v: int, nl: int):
    return [(v >> (16 * i)) & MASK for i in range(nl)]


def _mul_const(a, const: int, out_limbs: int, extra_add: int = 0):
    """(a * const + extra_add) mod 2^(16*out_limbs) as 16-bit limbs;
    a: (La, *b) int64 16-bit limbs."""
    La = a.shape[0]
    ncl = max(1, (const.bit_length() + 15) // 16)
    cl = _const_limbs(const, ncl)
    el = _const_limbs(extra_add, out_limbs)
    cols = torch.zeros((out_limbs + 1,) + tuple(a.shape[1:]),
                       dtype=torch.int64, device=a.device)
    for i in range(La):
        for j in range(min(ncl, out_limbs - i)):
            if cl[j]:
                cols[i + j] += a[i] * cl[j]
    out, carry = [], torch.zeros_like(a[0])
    for c in range(out_limbs):
        t = cols[c] + el[c] + carry
        out.append(t & MASK)
        carry = t >> 16
    return torch.stack(out)


def _add3_mod(x, y, z, nl: int):
    s = x + y + z
    out, carry = [], torch.zeros_like(s[0])
    for c in range(nl):
        t = s[c] + carry
        out.append(t & MASK)
        carry = t >> 16
    return torch.stack(out)


def _abs_tc(x, nl: int):
    """Two's-complement magnitude + sign of (nl, *b) limbs."""
    neg = (x[nl - 1] >> 15) & 1
    inv = MASK ^ x
    out, carry = [], torch.ones_like(x[0])
    for c in range(nl):
        t = inv[c] + carry
        out.append(t & MASK)
        carry = t >> 16
    mag = torch.where(neg[None].bool(), torch.stack(out), x)
    return mag, neg


def decompose(params: GLVParams, scalars: torch.Tensor):
    """(*b, n, 8) packed int32 scalars (< r) -> (words (5, *b, 2n) int64:
    |ki| packed u32 words [k1 block | k2 block], word axis leading, row 4
    the zero pad; neg (*b, 2n) int64 0/1 signs). Entry i maps to table
    point i mod n (the second block is the phi image)."""
    k = FF.unpack(scalars)                                # (16, *b, n)
    outs = []
    for g in (params.g1, params.g2):
        full = _mul_const(k, g, 26, extra_add=1 << (_S - 1))
        outs.append(full[17:26])
    c1m, c2m = outs
    k11 = k[:11]
    k1 = _add3_mod(k11, _mul_const(c1m, params.t1a, 11),
                   _mul_const(c2m, params.t2a, 11), 11)
    k2 = _add3_mod(torch.zeros_like(k11), _mul_const(c1m, params.t1b, 11),
                   _mul_const(c2m, params.t2b, 11), 11)
    packed, negs = [], []
    for kk in (k1, k2):
        mag, neg = _abs_tc(kk, 11)
        rows = [mag[2 * j] | (mag[2 * j + 1] << 16) for j in range(4)]
        rows.append(torch.zeros_like(rows[0]))
        packed.append(torch.stack(rows))
        negs.append(neg)
    return torch.cat(packed, dim=-1), torch.cat(negs, dim=-1)
