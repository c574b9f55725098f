"""Benchmark-scale sqchain fixtures (.zkey / .wtns), generated on the card.

Writes the same bytes as `ref/setup.setup` + `io/zkey.write_zkey` for the
same seed (the same formulas; canonical Montgomery residues and affine
points are unique), fast enough for 2^24 constraints:
  * the constraint system as COO arrays (numpy m, k, s and value words;
    sqchain_coo builds them with no Python loop per row);
  * every per-element scalar on the device in Fr Montgomery form: the
    domain's powers by ops/ntt.powers_mont, batch inversions by prefix
    and suffix products with one host pow per chunk, the a/b/c
    evaluations at tau by the front's kernel ops/front.fr_slot_acc (the
    entries binned by target, the Lagrange values gathered, as
    Prover._acc accumulates);
  * point tables by a 4-bit fixed-base ladder: 64 strict mixed adds per
    scalar against a host-built affine table of (d << 4w) * G. The G1
    tables read it as packed words (ops/fused.add_mixed_packed); the G2
    table reads it in limb form, as utils/points produces it
    (ops/fused.add_mixed, on the zkey's own twist). The ladders read the
    scalars as packed words already on the device;
  * batch inversion of the z coordinates and affine packing as torch ops;
  * the zkey written section by section from word and record arrays.

    python -m rapidsnark_tpu_torch.fixtures [log2_domain] [outdir] [--extra N]

writes sqchain<2^log2>.{zkey,wtns} (default 2^14, bench_fixtures/) and
prints the seconds of each part (fast_setup's `parts`) as JSON. With
`--extra N` (even) it writes the wide variant sqchainw<2^log2>.* instead:
the same chain and domain with N more private wires (sqchain_wide_coo),
so the MSMs run over 2^log2 + N points.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import device as D
from .io.zkey import COEF_DTYPE
from .ops import field as FF
from .ops import front as FRONT
from .ops import fused
from .ops.curve import FQ2, G1P, G2P, pack_point
from .ops.field import FQ, FR
from .ops.msm import point_inf, window_digits
from .ops.ntt import ints_to_words, powers_mont
from .ref import setup as S
from .ref.curve import G1_GEN, G2_GEN
from .ref.field import FR_CTX, R_FR, fr_w
from .utils.limbs import limbs_to_int
from .utils.logger import phase
from .utils.points import g1_affine_to_mont_limbs, g2_affine_to_mont_limbs

_WBITS = 4
_NWIN = 64
_CH = 1 << 18       # scalars per device chunk (ladders, batch inversions)
_EV_CH = 1 << 20    # wires per chunk of the wire scalars


# ---------------------------------------------------------------------------
# the constraint system as COO arrays
# ---------------------------------------------------------------------------

@dataclass
class CooR1CS:
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


def coo_from_r1cs(r1cs) -> CooR1CS:
    """ref.setup.R1CS (rows of {wire: value} dicts) -> CooR1CS. A Python
    loop per entry: for small systems and tests."""
    ent = [(m, k, s, v % R_FR)
           for m, rows in enumerate((r1cs.a_rows, r1cs.b_rows, r1cs.c_rows))
           for k, row in enumerate(rows) for s, v in row.items()]
    ent.sort(key=lambda e: e[:3])
    cols = [np.array([e[i] for e in ent], np.int64) for i in range(3)]
    vals = (ints_to_words([e[3] for e in ent]) if ent
            else np.zeros((0, 8), np.uint32))
    return CooR1CS(r1cs.n_vars, r1cs.n_public, len(r1cs.a_rows), *cols, vals)


def _words_of_small(v: np.ndarray) -> np.ndarray:
    """Non-negative ints < 2^32 -> (n, 8) uint32 words."""
    out = np.zeros((v.shape[0], 8), np.uint32)
    out[:, 0] = v
    return out


def sqchain_coo(n_steps: int) -> CooR1CS:
    """ref.setup.sqchain_r1cs as COO arrays, built by numpy: row k is
    x_k * x_k = x_{k+1} - k, so A and B hold wire(k) and C holds
    wire(k+1) with 1 and wire 0 with -k."""
    r_low = int(ints_to_words([R_FR])[0, 0])
    if n_steps >= r_low:
        raise ValueError("sqchain_coo: too many steps for one-word -k")
    k = np.arange(n_steps, dtype=np.int64)
    cur = k + 2                                          # wire(k)
    wire = np.where(k + 1 == n_steps, 1, k + 3)          # wire(k + 1)
    ones = _words_of_small(np.ones(n_steps, np.uint32))
    neg_k = np.zeros((n_steps, 8), np.uint32)
    neg_k[:] = ints_to_words([R_FR])[0]
    neg_k[:, 0] -= k.astype(np.uint32)
    neg_k[k == 0] = 0                                    # -0 = 0
    c_s = np.stack([np.zeros(n_steps, np.int64), wire], axis=1).reshape(-1)
    c_v = np.stack([neg_k, ones], axis=1).reshape(-1, 8)
    m = np.concatenate([np.zeros(n_steps, np.int64),
                        np.ones(n_steps, np.int64),
                        np.full(2 * n_steps, 2, np.int64)])
    kk = np.concatenate([k, k, np.repeat(k, 2)])
    s = np.concatenate([cur, cur, c_s])
    v = np.concatenate([ones, ones, c_v])
    return CooR1CS(n_steps + 2, 1, n_steps, m, kk, s, v)


def sqchain_wide_coo(n_steps: int, extra: int) -> CooR1CS:
    """sqchain_coo(n_steps) with `extra` (even) more private wires,
    n_steps + 2 onwards, that enter the C rows in pairs: pair j puts +1 at
    its first wire and -1 at its second in row j % n_steps. The witness
    gives both wires of a pair one value (wide_witness), so the pair
    cancels in value and every constraint holds. Each extra wire's c(tau)
    is +-L_k(tau), so it has a real point in the C table, and infinity in
    A and B; the domain stays the chain's."""
    if extra < 0 or extra % 2:
        raise ValueError(f"sqchain_wide_coo: extra = {extra} is not an "
                         "even count")
    base = sqchain_coo(n_steps)
    if not extra:
        return base
    pair = np.arange(extra // 2, dtype=np.int64)
    first = n_steps + 2 + 2 * pair
    neg_one = np.zeros((extra // 2, 8), np.uint32)
    neg_one[:] = ints_to_words([R_FR - 1])[0]
    c_at = int(np.searchsorted(base.m, 2))
    k = np.concatenate([base.k[c_at:], np.repeat(pair % n_steps, 2)])
    s = np.concatenate([base.s[c_at:],
                        np.stack([first, first + 1], axis=1).reshape(-1)])
    v = np.concatenate([base.value[c_at:], np.stack(
        [_words_of_small(np.ones(extra // 2, np.uint32)), neg_one],
        axis=1).reshape(-1, 8)])
    order = np.lexsort((s, k))
    return CooR1CS(
        base.n_vars + extra, base.n_public, n_steps,
        np.concatenate([base.m[:c_at], np.full(k.shape[0], 2, np.int64)]),
        np.concatenate([base.k[:c_at], k[order]]),
        np.concatenate([base.s[:c_at], s[order]]),
        np.concatenate([base.value[:c_at], v[order]]))


def wide_witness(n_steps: int, x0: int, extra: int, seed: int) -> list:
    """The witness of sqchain_wide_coo: the chain's (ref/setup
    sqchain_witness), then each pair's value twice; the values are
    residues below r drawn from numpy.random.RandomState(seed)."""
    w = np.random.RandomState(seed).randint(
        0, 1 << 32, size=(extra // 2, 8), dtype=np.uint64)
    w[:, 7] %= R_FR >> 224
    vals = [int.from_bytes(row.astype("<u4").tobytes(), "little")
            for row in w]
    return S.sqchain_witness(n_steps, x0) + [v for v in vals
                                             for _ in range(2)]


def _with_public_rows(coo: CooR1CS) -> CooR1CS:
    """ref.setup's extended A matrix: row n_constraints + i binds wire i
    (value 1) for i <= n_public, inserted after the last A entry."""
    npub = coo.n_public + 1
    at = int(np.searchsorted(coo.m, 1))
    ins = np.arange(npub, dtype=np.int64)

    def put(col, new):
        return np.concatenate([col[:at], new, col[at:]])

    return CooR1CS(
        coo.n_vars, coo.n_public, coo.n_constraints,
        put(coo.m, np.zeros(npub, np.int64)),
        put(coo.k, coo.n_constraints + ins), put(coo.s, ins),
        put(coo.value, _words_of_small(np.ones(npub, np.uint32))))


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

def split_coefs(zk, counts, vals):
    """A zkey whose coefficient record i is counted counts[i] times (the
    same m, c, s; parts in a row), with the values `vals` ((sum(counts),
    8) uint32 Montgomery words). Where each record's parts sum to its
    value mod r (Montgomery form is additive), every linear combination,
    and so the proof for the same (r, s), stays as it was: a denser
    coefficient section for the same circuit. The new zkey borrows zk's
    point tables; close zk only when done with both."""
    counts = np.asarray(counts, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    if vals.shape != (int(counts.sum()), 8):
        raise ValueError(f"split_coefs: {vals.shape} values for "
                         f"{int(counts.sum())} records")
    rep = lambda a: np.repeat(a, counts, axis=0)  # noqa: E731
    return dataclasses.replace(
        zk, n_coefs=vals.shape[0], coef_m=rep(zk.coef_m),
        coef_c=rep(zk.coef_c), coef_s=rep(zk.coef_s), coef_val=vals,
        file=None)


def split_thirds(zk, device=None):
    """split_coefs with every record v in three parts v c1, v c2 and
    v (1 - c1 - c2) (Montgomery words, by fr_pointwise on `device`, the
    card by default): K = 3 slots a row, the same proof for the same
    (r, s). Raises if a nonzero record's three parts are not distinct."""
    dev = D.resolve(device)
    cw = [_t32(np.frombuffer((c * (1 << 256) % R_FR).to_bytes(32, "little"),
                             "<u4").copy(), dev)
          for c in (0x1234567 + (1 << 200), 0x89ABCDEF + (1 << 190))]
    vals = _t32(zk.coef_val, dev)
    p1 = FRONT.fr_pointwise("mul", vals, cw[0])
    p2 = FRONT.fr_pointwise("mul", vals, cw[1])
    p3 = FRONT.fr_pointwise("sub", FRONT.fr_pointwise("sub", vals, p1), p2)
    nz = (vals != 0).any(dim=1)
    if bool(((p1 == p2).all(dim=1) & nz).any()) or \
            bool(((p1 == p3).all(dim=1) & nz).any()) or \
            bool(((p2 == p3).all(dim=1) & nz).any()):
        raise RuntimeError("a record's three parts are not distinct")
    parts3 = torch.stack([p1, p2, p3], dim=1).reshape(-1, 8).cpu().numpy()
    del vals, p1, p2, p3, nz
    return split_coefs(zk, np.full(zk.n_coefs, 3, np.int64),
                       parts3.view(np.uint32))


def _t32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32)).to(dev)


def _mont_const(v: int, dev) -> torch.Tensor:
    """Plain v -> its Fr Montgomery form as a (16, 1) limb column."""
    return FR.const(v * (1 << 256) % R_FR, (1,), dev)


def _batch_inv_dev(z, field=FQ):
    """(16, b) nonzero canonical Montgomery values of `field` -> their
    inverses: prefix and suffix products (log-step scans of muls) and
    one host inversion."""
    b = z.shape[1]
    mod = field.modulus
    z2 = torch.stack([z, z.flip(-1)], dim=1)             # (16, 2, b)
    lane = torch.arange(b, device=z.device)
    sh = 1
    while sh < b:
        rolled = torch.roll(z2, sh, dims=-1)
        z2 = torch.where((lane < sh)[None, None], z2, field.mul(z2, rolled))
        sh *= 2
    pref, suf = z2[:, 0], z2[:, 1].flip(-1)
    total = limbs_to_int(pref[:, -1].cpu().numpy())      # (prod)*R
    inv = pow(total * pow(1 << 256, -1, mod) % mod, -1, mod) * (1 << 256)
    inv = field.const(inv % mod, (b,), z.device)
    one = field.one_mont((b,), z.device)
    pprev = torch.where((lane == 0)[None], one, torch.roll(pref, 1, dims=1))
    tnext = torch.where((lane == b - 1)[None], one,
                        torch.roll(suf, -1, dims=1))
    return field.mul(field.mul(pprev, tnext), inv)


@contextlib.contextmanager
def _part(name: str, parts: dict, dev):
    """Time one part of the generator, its card work included."""
    with phase(name, parts):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# fixed-base ladders
# ---------------------------------------------------------------------------

def _window_table(gen, g2: bool):
    """Host table of (d << 4w) * gen for w < 64, d < 16 (plain affine
    ints, None = infinity)."""
    from .utils.hostcurve import G1H, G2H
    H = G2H if g2 else G1H
    entries = []
    base = H.from_affine(gen)
    for _ in range(_NWIN):
        acc = H.inf()
        for _ in range(1 << _WBITS):
            entries.append(H.to_affine(acc))
            acc = H.add(acc, base)
        for _ in range(_WBITS):
            base = H.double(base)
    return entries


def _limb_table(gen, g2: bool, dev) -> torch.Tensor:
    """The window table as (1024, A, 16) int32 Montgomery limbs, one
    16-bit limb per word; (0,0) = infinity."""
    conv = g2_affine_to_mont_limbs if g2 else g1_affine_to_mont_limbs
    arr = np.stack([conv(pt) for pt in _window_table(gen, g2)])
    return _t32(arr, dev)


def _pack_limbs(t: torch.Tensor) -> torch.Tensor:
    """(..., 16) limbs -> (..., 8) packed words."""
    return t[..., 0::2] | (t[..., 1::2] << 16)


def _ladder(curve, mixed_add, table, words):
    """sum_w T[w*16 + digit_w] for packed scalars words (b, 8), by 64
    mixed adds from infinity."""
    digits = window_digits(words, _WBITS)                # (64, b)
    acc = point_inf(curve, (words.shape[0],), words.device)
    for w in range(_NWIN):
        q = table[w * (1 << _WBITS) + digits[w]]
        acc = mixed_add(curve, acc, q)
    return acc


def fixed_base_g1(words: torch.Tensor) -> np.ndarray:
    """[k]G1 for scalars as (n, 8) int32 packed plain words on a device
    -> (n, 2, 8) u32 Montgomery affine words ((0,0) = infinity): the zkey
    section payload."""
    dev = words.device
    table = _pack_limbs(_limb_table(G1_GEN, False, dev))
    out = np.empty((words.shape[0], 2, 8), np.uint32)
    for lo in range(0, words.shape[0], _CH):
        acc = _ladder(G1P, fused.add_mixed_packed, table,
                      words[lo:lo + _CH].contiguous())
        x, y, z = (FF.unpack(acc[:, k]) for k in range(3))
        inf = FQ.is_zero(z)
        zi = _batch_inv_dev(FQ.select(inf, FQ.one_mont(z.shape[1:], dev), z))
        zero = torch.zeros_like(x)
        xa = FQ.select(inf, zero, FQ.mul(x, zi))
        ya = FQ.select(inf, zero, FQ.mul(y, zi))
        out[lo:lo + _CH] = pack_point((xa, ya)).cpu().numpy().view(np.uint32)
    return out


def fixed_base_g2(words: torch.Tensor) -> np.ndarray:
    """[k]G2 -> (n, 4, 8) u32 words (x.c0 x.c1 y.c0 y.c1)."""
    dev = words.device
    table = _limb_table(G2_GEN, True, dev)
    out = np.empty((words.shape[0], 4, 8), np.uint32)
    for lo in range(0, words.shape[0], _CH):
        acc = _ladder(G2P, fused.add_mixed, table,
                      words[lo:lo + _CH].contiguous())
        el = [FF.unpack(acc[:, k]) for k in range(6)]
        x, y, z = (el[0], el[1]), (el[2], el[3]), (el[4], el[5])
        b = (x[0].shape[1],)
        inf = FQ2.is_zero(z)
        m0, m1 = FQ.mul_many([(z[0], z[0]), (z[1], z[1])])
        norm = FQ.select(inf, FQ.one_mont(b, dev), FQ.add(m0, m1))
        ninv = _batch_inv_dev(norm)
        zi = (FQ.mul(z[0], ninv), FQ.neg(FQ.mul(z[1], ninv)))
        xa, ya = FQ2.mul_many([(x, zi), (y, zi)])
        zero = torch.zeros_like(xa[0])
        coords = [FQ.select(inf, zero, c) for c in (*xa, *ya)]
        out[lo:lo + _CH] = (torch.stack([FF.pack(c) for c in coords], dim=-2)
                            .cpu().numpy().view(np.uint32))
    return out


# ---------------------------------------------------------------------------
# the setup's scalars on the device
# ---------------------------------------------------------------------------

def _domain_scalars(domain: int, tau: int, dinv: int, dev):
    """Per domain row k, as (domain, 8) int32 packed words: the Lagrange
    values L_k(tau) = zt w^k / (N (tau - w^k)) (Montgomery form) and the
    H-point scalars -(R^2/2) Lhat_k(tau) zt / delta (plain), Lhat_k over
    the odd coset sigma_k = eta w^k (ref/setup.setup)."""
    power = domain.bit_length() - 1
    w, eta = fr_w(power), fr_w(power + 1)
    zt = (pow(tau, domain, R_FR) - 1) % R_FR
    if zt == 0:
        raise ValueError("tau fell inside the domain; change seed")
    zt_plus = (pow(tau, domain, R_FR) + 1) % R_FR
    neg_half_r2 = (-pow(2, -1, R_FR) * FR_CTX.r2) % R_FR
    tau_m = _mont_const(tau, dev)
    lag_c = _mont_const(zt * pow(domain, -1, R_FR), dev)
    neg_n = _mont_const(-domain, dev)
    h_c = _mont_const(neg_half_r2 * zt_plus % R_FR * zt % R_FR * dinv, dev)
    lag = torch.empty((domain, 8), dtype=torch.int32, device=dev)
    h_scal = torch.empty_like(lag)
    for lo in range(0, domain, _CH):
        b = min(_CH, domain - lo)
        wk = FF.unpack(powers_mont(w, b, pow(w, lo, R_FR), dev))
        dinvs = _batch_inv_dev(FR.sub(tau_m, wk), FR)
        lag[lo:lo + b] = FF.pack(FR.mul(FR.mul(wk, dinvs), lag_c))
        sig = FF.unpack(powers_mont(w, b, eta * pow(w, lo, R_FR), dev))
        hden = _batch_inv_dev(FR.mul(FR.sub(tau_m, sig), neg_n), FR)
        h_scal[lo:lo + b] = FF.pack(FR.from_mont(
            FR.mul(FR.mul(sig, hden), h_c)))
    return lag, h_scal


def _evaluations(coo: CooR1CS, lag: torch.Tensor, n_ab: int, dev):
    """sum_k v * L_k(tau) per (matrix, wire) -> (3 * n_vars, 8) packed
    Montgomery words (A, B, C wires in turn), by ops/front.fr_slot_acc:
    the entries binned by target m * n_vars + s (one slot a target, the
    rest spilled in row order; sqchain's C puts wire 0 in every row), the
    Lagrange table gathered by k, each value put in Montgomery form by
    fr_pointwise (a product by R^2); with the Montgomery words of the
    first n_ab entries' values (the zkey's coefficient records) as a
    (n_ab, 8) uint32 array."""
    nv = coo.n_vars
    if coo.m.shape[0] >= 1 << 31:
        raise ValueError("fast_setup: too many coefficients (>= 2^31)")
    r2 = _t32(ints_to_words([(1 << 512) % R_FR])[0], dev)
    vm = FRONT.fr_pointwise("mul", _t32(coo.value, dev), r2)
    coef = vm[:n_ab].cpu().numpy().view(np.uint32)
    k = torch.from_numpy(coo.k.astype(np.int32)).to(dev)
    tgt = torch.from_numpy(coo.m * nv + coo.s).to(dev)
    cs, cv, left, _ = FRONT.slot_tables(k, vm, tgt, 3 * nv, 1)
    spill = None
    if left.numel():
        spill, _ = FRONT.make_spill(k[left], vm[left], tgt[left], 3 * nv)
    # the kernel reads only the tables: free the entries first
    del vm, k, tgt, left
    return FRONT.fr_slot_acc(lag, cs, cv, spill), coef


def _wire_scalars(at: torch.Tensor, nv: int, n_public: int, toxic, dev):
    """Per wire, as (n_vars, 8) packed plain words: a(tau), b(tau) and
    K_s = (beta a + alpha b + c)(tau) / gamma for s <= n_public (IC), / delta
    above (points C)."""
    _, alpha, beta, gamma, delta = toxic
    alpha_m, beta_m = _mont_const(alpha, dev), _mont_const(beta, dev)
    ginv_m = _mont_const(pow(gamma, -1, R_FR), dev)
    dinv_m = _mont_const(pow(delta, -1, R_FR), dev)
    a_w, b_w, k_w = (torch.empty((nv, 8), dtype=torch.int32, device=dev)
                     for _ in range(3))
    for lo in range(0, nv, _EV_CH):
        hi = min(nv, lo + _EV_CH)
        a, b, c = (FF.unpack(at[j * nv + lo:j * nv + hi]) for j in range(3))
        kf = FR.add(FR.add(FR.mul(a, beta_m), FR.mul(b, alpha_m)), c)
        scale = torch.where(
            (torch.arange(lo, hi, device=dev) <= n_public)[None],
            ginv_m, dinv_m)
        a_w[lo:hi] = FF.pack(FR.from_mont(a))
        b_w[lo:hi] = FF.pack(FR.from_mont(b))
        k_w[lo:hi] = FF.pack(FR.from_mont(FR.mul(kf, scale)))
    return a_w, b_w, k_w


def fast_setup(coo: CooR1CS, seed: str = "rapidsnark-tpu-test",
               device=None, parts=None):
    """ref.setup.setup on the device: the same ZKeyData for the same seed
    (a ref.setup.R1CS goes in through coo_from_r1cs), with the point
    tables as (n, A, 8) u32 word arrays and the coefficient section as a
    record array (io/zkey.COEF_DTYPE); `parts`, when given, receives the
    seconds of each part."""
    from .ref.curve import G1 as RG1, G2
    from .ref.groth16 import ZKeyData

    dev = D.resolve(device)
    parts = {} if parts is None else parts
    with _part("rows", parts, dev):
        coo = _with_public_rows(coo)
    toxic = S._toxic(seed)
    tau, alpha, beta, gamma, delta = toxic
    domain = S._next_pow2(coo.n_constraints + coo.n_public + 1)
    nv, npub = coo.n_vars, coo.n_public
    dinv = pow(delta, -1, R_FR)
    with _part("scalars", parts, dev):
        lag, h_scal = _domain_scalars(domain, tau, dinv, dev)
    with _part("evaluations", parts, dev):
        n_ab = int(np.searchsorted(coo.m, 2))
        at, coef_words = _evaluations(coo, lag, n_ab, dev)
        del lag
    with _part("wire_scalars", parts, dev):
        a_w, b_w, k_w = _wire_scalars(at, nv, npub, toxic, dev)
        del at
        coefs = np.empty(n_ab, COEF_DTYPE)
        coefs["m"], coefs["c"], coefs["s"] = (coo.m[:n_ab], coo.k[:n_ab],
                                              coo.s[:n_ab])
        coefs["coef"] = coef_words
    del coo
    tables = {}
    for name, fn, words in (("points_a", fixed_base_g1, a_w),
                            ("points_b1", fixed_base_g1, b_w),
                            ("points_b2", fixed_base_g2, b_w),
                            ("points_c", fixed_base_g1, k_w[npub + 1:]),
                            ("points_h", fixed_base_g1, h_scal),
                            ("ic", fixed_base_g1, k_w[:npub + 1])):
        with _part(name, parts, dev):
            tables[name] = fn(words)
    with _part("vk", parts, dev):
        vk = dict(vk_alpha1=RG1.mul(G1_GEN, alpha),
                  vk_beta1=RG1.mul(G1_GEN, beta),
                  vk_beta2=G2.mul(G2_GEN, beta),
                  vk_gamma2=G2.mul(G2_GEN, gamma),
                  vk_delta1=RG1.mul(G1_GEN, delta),
                  vk_delta2=G2.mul(G2_GEN, delta))
    return ZKeyData(n_vars=nv, n_public=npub, domain_size=domain,
                    coefs=coefs, **vk, **tables)


def generate(logn: int, outdir: str, device=None, parts=None,
             extra: int = 0):
    """Write sqchain<2^logn>.{zkey,wtns} (seed bench-<logn>, witness
    x0 = 3) into outdir; returns (zkey_path, wtns_path). `parts`, when
    given, receives the seconds of each part (fast_setup's, then
    write_zkey and witness). With `extra` wires, the wide variant
    sqchainw<2^logn>.* (sqchain_wide_coo, seed bench-<logn>-w<extra>,
    the pairs' values drawn from RandomState(logn))."""
    from .io.wtns import write_wtns
    from .io.zkey import write_zkey

    dev = D.resolve(device)
    parts = {} if parts is None else parts
    os.makedirs(outdir, exist_ok=True)
    steps = (1 << logn) - 2  # domain = next_pow2(steps + 2) = 2^logn
    coo, seed = sqchain_coo(steps), f"bench-{logn}"
    if extra:
        coo, seed = sqchain_wide_coo(steps, extra), f"{seed}-w{extra}"
    zk = fast_setup(coo, seed=seed, device=dev, parts=parts)
    del coo
    name = f"sqchain{'w' if extra else ''}{1 << logn}"
    zpath = os.path.join(outdir, f"{name}.zkey")
    wpath = os.path.join(outdir, f"{name}.wtns")
    with _part("write_zkey", parts, dev):
        write_zkey(zpath, zk)
    del zk
    with _part("witness", parts, dev):
        write_wtns(wpath, wide_witness(steps, 3, extra, logn) if extra
                   else S.sqchain_witness(steps, 3))
    return zpath, wpath


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = 0
    if "--extra" in argv:
        at = argv.index("--extra")
        extra = int(argv[at + 1])
        del argv[at:at + 2]
    logn = int(argv[0]) if argv else 14
    outdir = argv[1] if len(argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench_fixtures")
    t0 = time.time()
    parts = {}
    zpath, _ = generate(logn, outdir, parts=parts, extra=extra)
    print(f"{os.path.basename(zpath)}: {time.time() - t0:.1f}s "
          f"{json.dumps(parts)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
