"""The input maker's Groth16 key: a snarkjs-layout proving key for a
constraint system, made from a seed on the device, held in memory.

A new rewrite of the port's generator (rapidsnark_tpu_torch/fixtures.py
fast_setup, ref/setup.py setup, at commit 6caa3f5) on the benchmark's own
code: the same toxic waste from the same seed string, the same scalars
and the same point conventions, so a key made here for a circuit is the
key those make, point for point:
  * the domain's Lagrange values L_k(tau) and the H-point scalars over the
    odd coset on plain torch limbs (fieldvec: chunked batch inversions);
  * each wire's a(tau), b(tau), c(tau) as sums over the COO entries
    (fieldvec.accumulate), and the IC / C scalars (beta a + alpha b + c)
    / gamma or / delta;
  * the point tables by a 4-bit fixed-base ladder, 64 strict mixed adds a
    scalar on the frozen kernels (frozen/kernels.py) against a host table
    of (d << 4w) G, then affine by a batch inversion of z.
The tables come back as host arrays in the zkey's word layout; the
toxic waste comes back too, for the reference."""

from __future__ import annotations

import contextlib
import hashlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import fieldvec as V
from .frozen import field as FF
from .frozen.curve import FQ2, G1P, G2P, pack_point
from .frozen.field import FQ, FR
from .frozen.hostcurve import G1H, G2H
from .frozen.kernels import add_mixed, add_mixed_packed
from .frozen.points import g1_affine_to_mont_limbs, g2_affine_to_mont_limbs
from .frozen.ref_curve import G1_GEN, G2_GEN
from .frozen.ref_field import FR_CTX, R_FR, fr_w

WBITS = 4
NWIN = 64


@dataclass
class Coo:
    """A constraint system as COO arrays sorted by (m, k, s): entry e puts
    the plain value value[e] ((nnz, 8) uint32 words, < r) at wire s[e] of
    row k[e] of matrix m[e] (0 / 1 / 2 = A / B / C); int64 m, k, s."""
    n_vars: int
    n_public: int
    n_constraints: int
    m: np.ndarray
    k: np.ndarray
    s: np.ndarray
    value: np.ndarray


@dataclass
class Key:
    """A proving key in the zkey's layout (host arrays: points as Montgomery
    affine words, (0,0) = infinity; coefficient values as Montgomery
    words), its verifying key as affine ints, and the toxic waste."""
    n_vars: int
    n_public: int
    domain: int
    coef_m: np.ndarray
    coef_c: np.ndarray
    coef_s: np.ndarray
    coef_val: np.ndarray
    points_a: np.ndarray
    points_b1: np.ndarray
    points_b2: np.ndarray
    points_c: np.ndarray
    points_h: np.ndarray
    ic: np.ndarray
    vk: dict
    toxic: tuple


def toxic(seed: str) -> tuple:
    """(tau, alpha, beta, gamma, delta) from a seed string, as the port's
    ref/setup._toxic draws them."""
    vals = []
    for name in ("tau", "alpha", "beta", "gamma", "delta"):
        h = hashlib.sha256(f"{seed}:{name}".encode()).digest()
        v = int.from_bytes(h, "little") % R_FR
        vals.append(v if v != 0 else 1)
    return tuple(vals)


def domain_of(coo: Coo) -> int:
    n = coo.n_constraints + coo.n_public + 1
    return 1 << (n - 1).bit_length()


def with_public_rows(coo: Coo) -> Coo:
    """snarkjs's extended A: row n_constraints + i binds wire i (value 1)
    for i <= n_public, after the last A entry."""
    npub = coo.n_public + 1
    at = int(np.searchsorted(coo.m, 1))
    ins = np.arange(npub, dtype=np.int64)
    ones = np.zeros((npub, 8), np.uint32)
    ones[:, 0] = 1

    def put(col, new):
        return np.concatenate([col[:at], new, col[at:]])

    return Coo(coo.n_vars, coo.n_public, coo.n_constraints,
               put(coo.m, np.zeros(npub, np.int64)),
               put(coo.k, coo.n_constraints + ins), put(coo.s, ins),
               put(coo.value, ones))


def lagrange(domain: int, tau: int, dev) -> torch.Tensor:
    """(16, domain) Montgomery limbs of L_k(tau) = zt w^k / (N (tau - w^k)),
    zt = tau^N - 1."""
    w = fr_w(domain.bit_length() - 1)
    zt = (pow(tau, domain, R_FR) - 1) % R_FR
    if zt == 0:
        raise ValueError("tau fell inside the domain; change the seed")
    tau_m = V.mont_const(FR, tau, dev)
    lag_c = V.mont_const(FR, zt * pow(domain, -1, R_FR), dev)
    out = torch.empty((16, domain), dtype=torch.int64, device=dev)
    for lo in range(0, domain, V.CHUNK):
        b = min(V.CHUNK, domain - lo)
        wk = V.powers(w, b, pow(w, lo, R_FR), dev)
        inv = V.batch_inv(FR.sub(tau_m, wk), FR)
        out[:, lo:lo + b] = FR.mul(FR.mul(wk, inv), lag_c)
    return out


def h_scalars(domain: int, tau: int, delta: int, dev) -> torch.Tensor:
    """(domain, 8) plain words of the H-point scalars
    -(R^2 / 2) Lhat_k(tau) zt / delta, Lhat_k over the odd coset
    sigma_k = eta w^k."""
    power = domain.bit_length() - 1
    w, eta = fr_w(power), fr_w(power + 1)
    zt = (pow(tau, domain, R_FR) - 1) % R_FR
    zt_plus = (pow(tau, domain, R_FR) + 1) % R_FR
    neg_half_r2 = (-pow(2, -1, R_FR) * FR_CTX.r2) % R_FR
    tau_m = V.mont_const(FR, tau, dev)
    neg_n = V.mont_const(FR, -domain, dev)
    h_c = V.mont_const(FR, neg_half_r2 * zt_plus % R_FR * zt % R_FR
                       * pow(delta, -1, R_FR), dev)
    out = torch.empty((domain, 8), dtype=torch.int32, device=dev)
    for lo in range(0, domain, V.CHUNK):
        b = min(V.CHUNK, domain - lo)
        sig = V.powers(w, b, eta * pow(w, lo, R_FR), dev)
        den = V.batch_inv(FR.mul(FR.sub(tau_m, sig), neg_n), FR)
        out[lo:lo + b] = FF.pack(FR.from_mont(FR.mul(FR.mul(sig, den), h_c)))
    return out


def evaluations(coo: Coo, lag: torch.Tensor, dev) -> torch.Tensor:
    """(16, 3 n_vars) Montgomery limbs: sum_k v L_k(tau) per (matrix, wire),
    A's wires, then B's, then C's."""
    nv = coo.n_vars
    k = torch.from_numpy(coo.k).to(dev)
    tgt = torch.from_numpy(coo.m * nv + coo.s).to(dev)
    return V.accumulate(lag, k, V.words_t(coo.value, dev), tgt, 3 * nv)


def wire_scalars(at: torch.Tensor, nv: int, n_public: int, tx, dev):
    """Per wire, (n_vars, 8) plain words each: a(tau), b(tau) and
    K_s = (beta a + alpha b + c)(tau) / gamma for s <= n_public (IC),
    / delta above (points C); CHUNK wires at a time."""
    _, alpha, beta, gamma, delta = tx
    alpha_m, beta_m = (V.mont_const(FR, v, dev) for v in (alpha, beta))
    ginv_m = V.mont_const(FR, pow(gamma, -1, R_FR), dev)
    dinv_m = V.mont_const(FR, pow(delta, -1, R_FR), dev)
    a_w, b_w, k_w = (torch.empty((nv, 8), dtype=torch.int32, device=dev)
                     for _ in range(3))
    for lo in range(0, nv, V.CHUNK):
        hi = min(nv, lo + V.CHUNK)
        a, b, c = (at[:, j * nv + lo:j * nv + hi] for j in range(3))
        kf = FR.add(FR.add(FR.mul(a, beta_m), FR.mul(b, alpha_m)), c)
        scale = torch.where(
            (torch.arange(lo, hi, device=dev) <= n_public)[None],
            ginv_m, dinv_m)
        a_w[lo:hi] = FF.pack(FR.from_mont(a))
        b_w[lo:hi] = FF.pack(FR.from_mont(b))
        k_w[lo:hi] = FF.pack(FR.from_mont(FR.mul(kf, scale)))
    return a_w, b_w, k_w


# ----------------------------------------------------------------------------
# fixed-base ladders (rapidsnark_tpu_torch/fixtures.py at commit 6caa3f5)
# ----------------------------------------------------------------------------

def _window_table(gen, g2: bool):
    """Host table of (d << 4w) * gen for w < 64, d < 16 (affine ints, None
    = infinity)."""
    H = G2H if g2 else G1H
    entries = []
    base = H.from_affine(gen)
    for _ in range(NWIN):
        acc = H.inf()
        for _ in range(1 << WBITS):
            entries.append(H.to_affine(acc))
            acc = H.add(acc, base)
        for _ in range(WBITS):
            base = H.double(base)
    return entries


def _limb_table(gen, g2: bool, dev) -> torch.Tensor:
    """The window table as (1024, A, 16) int32 Montgomery limbs."""
    conv = g2_affine_to_mont_limbs if g2 else g1_affine_to_mont_limbs
    arr = np.stack([conv(pt) for pt in _window_table(gen, g2)])
    return V.words_t(arr, dev)


def _window_digits(words: torch.Tensor) -> torch.Tensor:
    """(n, 8) packed scalars -> (64, n) 4-bit digits."""
    s = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(s[:, (w * WBITS) // 32] >> ((w * WBITS) % 32)) & 15
                        for w in range(NWIN)])


def _ladder(curve, mixed_add, table, words):
    """sum_w T[w*16 + digit_w] for packed scalars (b, 8), 64 mixed adds
    from infinity."""
    digits = _window_digits(words)
    acc = pack_point(curve.inf((words.shape[0],), words.device))
    for w in range(NWIN):
        acc = mixed_add(curve, acc, table[w * (1 << WBITS) + digits[w]])
    return acc


def fixed_base_g1(words: torch.Tensor, chunk: int) -> np.ndarray:
    """[k]G1 for (n, 8) plain scalar words -> (n, 2, 8) uint32 Montgomery
    affine words, (0,0) = infinity."""
    dev = words.device
    tl = _limb_table(G1_GEN, False, dev)
    table = tl[..., 0::2] | (tl[..., 1::2] << 16)
    out = np.empty((words.shape[0], 2, 8), np.uint32)
    for lo in range(0, words.shape[0], chunk):
        acc = _ladder(G1P, add_mixed_packed, table,
                      words[lo:lo + chunk].contiguous())
        x, y, z = (FF.unpack(acc[:, k]) for k in range(3))
        del acc
        inf = FQ.is_zero(z)
        zi = V.batch_inv(FQ.select(inf, FQ.one_mont(z.shape[1:], dev), z),
                         FQ)
        zero = torch.zeros_like(x)
        xa = FQ.select(inf, zero, FQ.mul(x, zi))
        ya = FQ.select(inf, zero, FQ.mul(y, zi))
        out[lo:lo + chunk] = pack_point((xa, ya)).cpu().numpy().view(
            np.uint32)
    return out


def fixed_base_g2(words: torch.Tensor, chunk: int) -> np.ndarray:
    """[k]G2 -> (n, 4, 8) uint32 words (x.c0 x.c1 y.c0 y.c1)."""
    dev = words.device
    table = _limb_table(G2_GEN, True, dev)
    out = np.empty((words.shape[0], 4, 8), np.uint32)
    for lo in range(0, words.shape[0], chunk):
        acc = _ladder(G2P, add_mixed, table,
                      words[lo:lo + chunk].contiguous())
        el = [FF.unpack(acc[:, k]) for k in range(6)]
        del acc
        x, y, z = (el[0], el[1]), (el[2], el[3]), (el[4], el[5])
        b = (x[0].shape[1],)
        inf = FQ2.is_zero(z)
        m0, m1 = FQ.mul_many([(z[0], z[0]), (z[1], z[1])])
        ninv = V.batch_inv(FQ.select(inf, FQ.one_mont(b, dev),
                                     FQ.add(m0, m1)), FQ)
        zi = (FQ.mul(z[0], ninv), FQ.neg(FQ.mul(z[1], ninv)))
        xa, ya = FQ2.mul_many([(x, zi), (y, zi)])
        zero = torch.zeros_like(xa[0])
        coords = [FQ.select(inf, zero, c) for c in (*xa, *ya)]
        out[lo:lo + chunk] = (torch.stack([FF.pack(c) for c in coords],
                                          dim=-2).cpu().numpy()
                              .view(np.uint32))
    return out


@contextlib.contextmanager
def _part(name: str, parts: dict, dev):
    t0 = time.perf_counter()
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0


def make_key(coo: Coo, seed: str, dev, parts: dict = None,
             chunk: int = V.CHUNK) -> Key:
    """The proving key of `coo` for the toxic waste of `seed`, made on dev;
    `parts` receives the seconds of each part."""
    parts = {} if parts is None else parts
    dev = torch.device(dev)
    tx = toxic(seed)
    tau, alpha, beta, gamma, delta = tx
    rows = with_public_rows(coo)
    domain = domain_of(coo)
    nv, npub = coo.n_vars, coo.n_public
    with _part("scalars", parts, dev):
        lag = lagrange(domain, tau, dev)
        h_w = h_scalars(domain, tau, delta, dev)
    with _part("evaluations", parts, dev):
        at = evaluations(rows, lag, dev)
        del lag
        a_w, b_w, k_w = wire_scalars(at, nv, npub, tx, dev)
        del at
    with _part("coefficients", parts, dev):
        n_ab = int(np.searchsorted(rows.m, 2))
        coef_val = np.empty((n_ab, 8), np.uint32)
        for lo in range(0, n_ab, chunk):
            v = V.words_t(rows.value[lo:min(n_ab, lo + chunk)], dev)
            coef_val[lo:lo + v.shape[0]] = FF.pack(FR.to_mont(
                FF.unpack(v))).cpu().numpy().view(np.uint32)
    tables = {}
    for name, fn, words in (("points_a", fixed_base_g1, a_w),
                            ("points_b1", fixed_base_g1, b_w),
                            ("points_b2", fixed_base_g2, b_w),
                            ("points_c", fixed_base_g1, k_w[npub + 1:]),
                            ("points_h", fixed_base_g1, h_w),
                            ("ic", fixed_base_g1, k_w[:npub + 1])):
        with _part(name, parts, dev):
            tables[name] = fn(words, chunk)
    del a_w, b_w, k_w, h_w
    with _part("vk", parts, dev):
        vk = {"alpha1": G1H.to_affine(G1H.mul(G1H.from_affine(G1_GEN),
                                              alpha)),
              "beta1": G1H.to_affine(G1H.mul(G1H.from_affine(G1_GEN), beta)),
              "delta1": G1H.to_affine(G1H.mul(G1H.from_affine(G1_GEN),
                                              delta))}
        for nm, v in (("beta2", beta), ("gamma2", gamma), ("delta2", delta)):
            vk[nm] = G2H.to_affine(G2H.mul(G2H.from_affine(G2_GEN), v))
    return Key(nv, npub, domain,
               rows.m[:n_ab].astype(np.uint32), rows.k[:n_ab].astype(
                   np.uint32), rows.s[:n_ab].astype(np.uint32), coef_val,
               vk=vk, toxic=tx, **tables)
