# Frozen copy of rapidsnark_tpu_torch/ref/field.py at commit 6caa3f5 for the benchmark's yardstick.
# Unchanged.
"""BN254 field towers in pure Python.

Base fields:
  Fq (coordinate field), modulus P
  Fr (scalar field),     modulus R_FR

Extension tower used for the optimal-ate pairing (standard Ethereum /
py_ecc construction):
  Fq2  = Fq[i] / (i^2 + 1)
  Fq12 = Fq[w] / (w^12 - 18 w^6 + 82)      (w^6 = 9 + i)

Montgomery helpers mirror the byte-level conventions of the reference
prover (see rapidsnark src/groth16.cpp:58-166 and SURVEY.md §3.1):
R = 2^256, field elements on disk are little-endian 32-byte integers,
zkey constants are stored in Montgomery form, witness values in standard
form.
"""

from __future__ import annotations

# BN254 / alt_bn128 moduli (reference hardcodes R_FR at
# rapidsnark src/main_prover.cpp:34).
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Montgomery radix shared by ffiasm's 4x64-bit layout, the 16x16-bit
# plain layout and the 8x32-bit kernel layout: R = 2^256.
R_MONT = 1 << 256
R_MONT_MASK = R_MONT - 1

# Fr two-adic structure (computed with the same search ffjavascript /
# ffiasm use: smallest nqr with nqr^((r-1)/2) == -1, starting from 2).
FR_S = 28
FR_NQR = 5
# w[28] = 5^((r-1) / 2^28) mod r — primitive 2^28-th root of unity.
FR_W28 = 19103219067921713944291392827692070036145651957329286315305642004821462161904


def fr_w(power: int) -> int:
    """Primitive 2^power-th root of unity in Fr (ffjavascript w[] chain)."""
    if power > FR_S:
        raise ValueError(f"no 2^{power}-th root of unity in Fr (s={FR_S})")
    w = FR_W28
    for _ in range(FR_S - power):
        w = w * w % R_FR
    return w


# ---------------------------------------------------------------------------
# Montgomery arithmetic on plain ints (byte-level semantics of the reference)
# ---------------------------------------------------------------------------

def mont_mul(a: int, b: int, mod: int) -> int:
    """Montgomery product a*b*R^-1 mod `mod` with R = 2^256."""
    return a * b * pow(R_MONT, -1, mod) % mod


class MontCtx:
    """Cached Montgomery context for one modulus."""

    def __init__(self, mod: int):
        self.mod = mod
        self.rinv = pow(R_MONT, -1, mod)
        self.r1 = R_MONT % mod
        self.r2 = R_MONT * R_MONT % mod
        # -mod^-1 mod 2^16 (the 16-bit word n0inv of the plain field ops)
        self.n0inv16 = (-pow(mod, -1, 1 << 16)) % (1 << 16)

    def mul(self, a: int, b: int) -> int:
        return a * b * self.rinv % self.mod

    def to_mont(self, a: int) -> int:
        return a * self.r1 % self.mod

    def from_mont(self, a: int) -> int:
        return a * self.rinv % self.mod


FQ_CTX = MontCtx(P)
FR_CTX = MontCtx(R_FR)


# ---------------------------------------------------------------------------
# Fq2 as coefficient pairs (c0, c1), i^2 = -1
# ---------------------------------------------------------------------------

def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_mul(a, b):
    # (a0 + a1 i)(b0 + b1 i) = a0 b0 - a1 b1 + (a0 b1 + a1 b0) i
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def fq2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fq2_inv(a):
    # 1/(a0 + a1 i) = (a0 - a1 i) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = pow(norm, -1, P)
    return (a[0] * ninv % P, (-a[1]) * ninv % P)


def fq2_eq(a, b):
    return a[0] % P == b[0] % P and a[1] % P == b[1] % P


FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
# Twisted curve constant: b2 = 3 / (9 + i)
FQ2_B = fq2_mul((3, 0), fq2_inv((9, 1)))


# ---------------------------------------------------------------------------
# Fq12 as degree-12 polynomials over Fq, modulus w^12 - 18 w^6 + 82
# ---------------------------------------------------------------------------

_FQ12_DEG = 12
# modulus_coeffs[k] is the coefficient of w^k in (w^12 mod poly) sign
# convention: w^12 = -(82) + 18 w^6, i.e. reduction subtracts
# top * (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0).
_FQ12_MOD_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)


class Fq12:
    """Fq12 element as a tuple of 12 Fq coefficients (w^0 .. w^11)."""

    __slots__ = ("c",)

    def __init__(self, coeffs):
        assert len(coeffs) == _FQ12_DEG
        self.c = tuple(x % P for x in coeffs)

    @staticmethod
    def zero() -> "Fq12":
        return Fq12((0,) * 12)

    @staticmethod
    def one() -> "Fq12":
        return Fq12((1,) + (0,) * 11)

    @staticmethod
    def from_fq(x: int) -> "Fq12":
        return Fq12((x,) + (0,) * 11)

    @staticmethod
    def from_fq2(a) -> "Fq12":
        """Embed a0 + a1*i with i = w^6 - 9."""
        c = [0] * 12
        c[0] = (a[0] - 9 * a[1]) % P
        c[6] = a[1] % P
        return Fq12(c)

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(tuple(x + y for x, y in zip(self.c, o.c)))

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(tuple(x - y for x, y in zip(self.c, o.c)))

    def __neg__(self) -> "Fq12":
        return Fq12(tuple(-x for x in self.c))

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq12(tuple(x * o for x in self.c))
        b = [0] * (2 * _FQ12_DEG - 1)
        a, bo = self.c, o.c
        for i in range(_FQ12_DEG):
            ai = a[i]
            if ai:
                for j in range(_FQ12_DEG):
                    b[i + j] += ai * bo[j]
        # reduce degrees 22..12
        for exp in range(2 * _FQ12_DEG - 2, _FQ12_DEG - 1, -1):
            top = b[exp]
            if top:
                b[exp] = 0
                b[exp - 12] -= top * 82
                b[exp - 6] += top * 18
        return Fq12(b[:_FQ12_DEG])

    __rmul__ = __mul__

    def square(self) -> "Fq12":
        return self * self

    def inv(self) -> "Fq12":
        """Extended-Euclid inverse in the polynomial quotient ring."""
        lm, hm = [1] + [0] * 12, [0] * 13
        low = list(self.c) + [0]
        high = list(_FQ12_MOD_COEFFS) + [1]
        while _poly_deg(low):
            r = _poly_rounded_div(high, low)
            r += [0] * (13 - len(r))
            nm = list(hm)
            new = list(high)
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        linv = pow(low[0], -1, P)
        return Fq12([x * linv % P for x in lm[:12]])

    def __truediv__(self, o: "Fq12") -> "Fq12":
        return self * o.inv()

    def __pow__(self, e: int) -> "Fq12":
        result = Fq12.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c == o.c

    def __hash__(self):
        return hash(self.c)

    def is_one(self) -> bool:
        return self.c == Fq12.one().c

    def __repr__(self):
        return f"Fq12{self.c}"


def _poly_deg(p) -> int:
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


def _poly_rounded_div(a, b):
    dega, degb = _poly_deg(a), _poly_deg(b)
    temp = list(a)
    out = [0] * len(a)
    binv = pow(b[degb], -1, P)
    for i in range(dega - degb, -1, -1):
        out[i] = (out[i] + temp[degb + i] * binv) % P
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - out[i] * b[c]) % P
    return out[: _poly_deg(out) + 1]
