"""Benchmark-scale sqchain fixtures (.zkey / .wtns), generated on the card.

Writes the same bytes as `ref/setup.setup` + `io/zkey.write_zkey` for the
same seed (the same formulas; affine points are unique), fast enough for
2^20 constraints:
  * host scalars with Montgomery batch inversion (one pow per array);
  * point tables by a 4-bit fixed-base ladder: 64 strict mixed adds per
    scalar against a host-built affine table of (d << 4w) * G. The G1
    tables read it as packed words (ops/fused.add_mixed_packed); the G2
    table reads it in limb form, as utils/points produces it
    (ops/fused.add_mixed, on the zkey's own twist);
  * batch inversion of the z coordinates and affine packing as torch ops.

    python -m rapidsnark_tpu_torch.fixtures [log2_domain] [outdir]

writes sqchain<2^log2>.{zkey,wtns} (default 2^14, bench_fixtures/).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from . import device as D
from .ops import field as FF
from .ops import fused
from .ops.curve import FQ2, G1P, G2P, pack_point
from .ops.field import FQ
from .ops.msm import point_inf, window_digits
from .ref import setup as S
from .ref.curve import G1_GEN, G2_GEN
from .ref.field import FR_CTX, FQ_CTX, P, R_FR, fr_w
from .utils.points import g1_affine_to_mont_limbs, g2_affine_to_mont_limbs

_WBITS = 4
_NWIN = 64
_CH = 1 << 18   # scalars per device chunk


def batch_inv(vals, mod):
    """Montgomery batch inversion: one pow(-1) for the whole list."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % mod
    inv_all = pow(prefix[n], -1, mod)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % mod
        inv_all = inv_all * vals[i] % mod
    return out


def _ints_to_words(vals) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), 8).copy()


def _t32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32)).to(dev)


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


def _batch_inv_dev(z):
    """(16, b) nonzero canonical Montgomery values -> their inverses:
    prefix and suffix products (log-step scans of Fq muls) and one host
    inversion."""
    from .utils.limbs import limbs_to_int
    b = z.shape[1]
    z2 = torch.stack([z, z.flip(-1)], dim=1)             # (16, 2, b)
    lane = torch.arange(b, device=z.device)
    sh = 1
    while sh < b:
        rolled = torch.roll(z2, sh, dims=-1)
        z2 = torch.where((lane < sh)[None, None], z2, FQ.mul(z2, rolled))
        sh *= 2
    pref, suf = z2[:, 0], z2[:, 1].flip(-1)
    total = FQ_CTX.from_mont(limbs_to_int(pref[:, -1].cpu().numpy()))
    inv = FQ.const(FQ_CTX.to_mont(pow(total, -1, P)), (b,), z.device)
    one = FQ.one_mont((b,), z.device)
    pprev = torch.where((lane == 0)[None], one, torch.roll(pref, 1, dims=1))
    tnext = torch.where((lane == b - 1)[None], one,
                        torch.roll(suf, -1, dims=1))
    return FQ.mul(FQ.mul(pprev, tnext), inv)


def fixed_base_g1(scalars, device) -> np.ndarray:
    """[k]G1 for plain ints -> (n, 2, 8) u32 Montgomery affine words
    ((0,0) = infinity): the zkey section payload."""
    table = _pack_limbs(_limb_table(G1_GEN, False, device))
    out = []
    for lo in range(0, len(scalars), _CH):
        words = _t32(_ints_to_words(scalars[lo:lo + _CH]), device)
        acc = _ladder(G1P, fused.add_mixed_packed, table, words)
        x, y, z = (FF.unpack(acc[:, k]) for k in range(3))
        inf = FQ.is_zero(z)
        zi = _batch_inv_dev(FQ.select(inf, FQ.one_mont(z.shape[1:],
                                                       z.device), z))
        zero = torch.zeros_like(x)
        xa = FQ.select(inf, zero, FQ.mul(x, zi))
        ya = FQ.select(inf, zero, FQ.mul(y, zi))
        out.append(pack_point((xa, ya)).cpu().numpy().view(np.uint32))
    return np.concatenate(out, axis=0)


def fixed_base_g2(scalars, device) -> np.ndarray:
    """[k]G2 -> (n, 4, 8) u32 words (x.c0 x.c1 y.c0 y.c1)."""
    table = _limb_table(G2_GEN, True, device)
    out = []
    for lo in range(0, len(scalars), _CH):
        words = _t32(_ints_to_words(scalars[lo:lo + _CH]), device)
        acc = _ladder(G2P, fused.add_mixed, table, words)
        el = [FF.unpack(acc[:, k]) for k in range(6)]
        x, y, z = (el[0], el[1]), (el[2], el[3]), (el[4], el[5])
        b = (x[0].shape[1],)
        inf = FQ2.is_zero(z)
        m0, m1 = FQ.mul_many([(z[0], z[0]), (z[1], z[1])])
        norm = FQ.select(inf, FQ.one_mont(b, device), FQ.add(m0, m1))
        ninv = _batch_inv_dev(norm)
        zi = (FQ.mul(z[0], ninv), FQ.neg(FQ.mul(z[1], ninv)))
        xa, ya = FQ2.mul_many([(x, zi), (y, zi)])
        zero = torch.zeros_like(xa[0])
        coords = [FQ.select(inf, zero, c) for c in (*xa, *ya)]
        out.append(torch.stack([FF.pack(c) for c in coords], dim=-2)
                   .cpu().numpy().view(np.uint32))
    return np.concatenate(out, axis=0)


def fast_setup(r1cs, seed: str = "rapidsnark-tpu-test", device=None):
    """ref.setup.setup with batched inversions and device point tables;
    the same output for the same seed."""
    from .ref.curve import G1 as RG1, G2
    from .ref.groth16 import ZKeyData

    dev = D.resolve(device)
    tau, alpha, beta, gamma, delta = S._toxic(seed)
    n_constraints = len(r1cs.a_rows)
    domain = S._next_pow2(n_constraints + r1cs.n_public + 1)
    power = domain.bit_length() - 1
    w = fr_w(power)
    eta = fr_w(power + 1)

    a_rows = [dict(row) for row in r1cs.a_rows]
    b_rows = [dict(row) for row in r1cs.b_rows]
    c_rows = [dict(row) for row in r1cs.c_rows]
    for i in range(r1cs.n_public + 1):
        a_rows.append({i: 1})
        b_rows.append({})
        c_rows.append({})

    zt = (pow(tau, domain, R_FR) - 1) % R_FR
    assert zt != 0
    ninv = pow(domain, -1, R_FR)
    wks, wk = [], 1
    for _ in range(domain):
        wks.append(wk)
        wk = wk * w % R_FR
    dinvs = batch_inv([(tau - v) % R_FR for v in wks], R_FR)
    lag = [zt * wks[k] % R_FR * dinvs[k] % R_FR * ninv % R_FR
           for k in range(domain)]

    at = {"a": [0] * r1cs.n_vars, "b": [0] * r1cs.n_vars,
          "c": [0] * r1cs.n_vars}
    for key, rows in (("a", a_rows), ("b", b_rows), ("c", c_rows)):
        vec = at[key]
        for k, row in enumerate(rows):
            for s, v in row.items():
                vec[s] = (vec[s] + v * lag[k]) % R_FR
    a_at, b_at, c_at = at["a"], at["b"], at["c"]

    ginv = pow(gamma, -1, R_FR)
    dinv = pow(delta, -1, R_FR)
    kf = [(beta * a_at[s] + alpha * b_at[s] + c_at[s]) % R_FR
          for s in range(r1cs.n_vars)]
    zt_plus = (pow(tau, domain, R_FR) + 1) % R_FR
    neg_half_r2 = (-pow(2, -1, R_FR) * FR_CTX.r2) % R_FR
    sigmas, sig = [], eta
    for _ in range(domain):
        sigmas.append(sig)
        sig = sig * w % R_FR
    hden = batch_inv([(-domain * (tau - s)) % R_FR for s in sigmas], R_FR)
    h_scal = [neg_half_r2 * (zt_plus * sigmas[k] % R_FR) % R_FR
              * hden[k] % R_FR * zt % R_FR * dinv % R_FR
              for k in range(domain)]

    ic_scal = [kf[s] * ginv % R_FR for s in range(r1cs.n_public + 1)]
    c_scal = [kf[s] * dinv % R_FR
              for s in range(r1cs.n_public + 1, r1cs.n_vars)]
    coefs = []
    for m, rows in ((0, a_rows), (1, b_rows)):
        for k, row in enumerate(rows):
            for s, v in sorted(row.items()):
                coefs.append((m, k, s, FR_CTX.to_mont(v % R_FR)))

    return ZKeyData(
        n_vars=r1cs.n_vars, n_public=r1cs.n_public, domain_size=domain,
        coefs=coefs,
        vk_alpha1=RG1.mul(G1_GEN, alpha), vk_beta1=RG1.mul(G1_GEN, beta),
        vk_beta2=G2.mul(G2_GEN, beta), vk_gamma2=G2.mul(G2_GEN, gamma),
        vk_delta1=RG1.mul(G1_GEN, delta), vk_delta2=G2.mul(G2_GEN, delta),
        points_a=fixed_base_g1(a_at, dev),
        points_b1=fixed_base_g1(b_at, dev),
        points_b2=fixed_base_g2(b_at, dev),
        points_c=fixed_base_g1(c_scal, dev),
        points_h=fixed_base_g1(h_scal, dev),
        ic=fixed_base_g1(ic_scal, dev),
    )


def generate(logn: int, outdir: str, device=None):
    """Write sqchain<2^logn>.{zkey,wtns} (seed bench-<logn>, witness
    x0 = 3) into outdir; returns (zkey_path, wtns_path)."""
    from .io.wtns import write_wtns
    from .io.zkey import write_zkey

    os.makedirs(outdir, exist_ok=True)
    steps = (1 << logn) - 2  # domain = next_pow2(steps + 2) = 2^logn
    zk = fast_setup(S.sqchain_r1cs(steps), seed=f"bench-{logn}",
                    device=device)
    name = f"sqchain{1 << logn}"
    zpath = os.path.join(outdir, f"{name}.zkey")
    wpath = os.path.join(outdir, f"{name}.wtns")
    write_zkey(zpath, zk)
    write_wtns(wpath, S.sqchain_witness(steps, 3))
    return zpath, wpath


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    logn = int(argv[0]) if argv else 14
    outdir = argv[1] if len(argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench_fixtures")
    t0 = time.time()
    zpath, _ = generate(logn, outdir)
    print(f"{os.path.basename(zpath)}: {time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
