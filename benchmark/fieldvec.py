"""Vector arithmetic over Fr and Fq on plain torch limbs, shared by the
input maker (keygen.py) and the reference (reference.py).

Elements are (16, *batch) int64 tensors of 16-bit limbs (frozen/field.py);
tables travel as (n, 8) int32 packed words. Every operation here is plain
PyTorch, so it runs alike on the card and on the CPU; on the card it is
launch-bound below ~2^20 elements, which is why the batch inversions and
the accumulations work on chunks of CHUNK elements."""

from __future__ import annotations

import numpy as np
import torch

from .frozen import field as FF
from .frozen.field import FR
from .frozen.limbs import limbs_to_int
from .frozen.ref_field import R_FR

CHUNK = 1 << 22


def ints_to_words(vals) -> np.ndarray:
    """Python ints (< 2^256) -> (n, 8) uint32 little-endian words."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), 8).copy()


def words_t(a: np.ndarray, dev) -> torch.Tensor:
    """(..., 8) uint32 words -> int32 tensor of the same bits on dev."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32)).to(dev)


def mont_const(field, v: int, dev) -> torch.Tensor:
    """Plain v -> its Montgomery form as a (16, 1) limb column."""
    return field.const(v * (1 << 256) % field.modulus, (1,), dev)


def limb_int(col: torch.Tensor) -> int:
    """A (16,) limb vector -> its int."""
    return limbs_to_int(col.cpu().numpy())


def _hillis(z: torch.Tensor, field) -> torch.Tensor:
    """Inclusive prefix products along the last axis by log-step scans."""
    b = z.shape[-1]
    lane = torch.arange(b, device=z.device)
    sh = 1
    while sh < b:
        z = torch.where(lane < sh, z, field.mul(z, torch.roll(z, sh, -1)))
        sh *= 2
    return z


def prefix_products(z: torch.Tensor, field, block: int = 64):
    """Inclusive prefix products of (16, *lead, b) Montgomery values along
    the last axis: log-step scans within blocks of `block`, the blocks'
    totals scanned the same way one level up, then one product a value,
    so a long axis costs ~log2(block) + 1 products a value, not log2(b)."""
    b = z.shape[-1]
    if b <= block * 4:
        return _hillis(z, field)
    nb = -(-b // block)
    pad = nb * block - b
    if pad:
        one = field.one_mont(tuple(z.shape[1:-1]) + (pad,), z.device)
        z = torch.cat([z, one], dim=-1)
    within = _hillis(z.reshape(z.shape[:-1] + (nb, block)), field)
    tot = prefix_products(within[..., -1], field, block)   # (..., nb)
    one = field.one_mont(tuple(tot.shape[1:-1]) + (1,), z.device)
    excl = torch.cat([one, tot[..., :-1]], dim=-1)
    out = field.mul(within, excl[..., None]).reshape(z.shape)
    return out[..., :b]


def batch_inv(z: torch.Tensor, field) -> torch.Tensor:
    """(16, b) nonzero canonical Montgomery values -> their inverses:
    prefix and suffix products (prefix_products) and one host inversion,
    as the generator's _batch_inv_dev (rapidsnark_tpu_torch/fixtures.py
    at commit 6caa3f5) computes them with one level of scans."""
    b = z.shape[1]
    mod = field.modulus
    z2 = prefix_products(torch.stack([z, z.flip(-1)], dim=1), field)
    pref, suf = z2[:, 0], z2[:, 1].flip(-1)
    total = limb_int(pref[:, -1])                        # (prod) * R
    inv = pow(total * pow(1 << 256, -1, mod) % mod, -1, mod) * (1 << 256)
    inv = field.const(inv % mod, (b,), z.device)
    one = field.one_mont((1,), z.device)
    pprev = torch.cat([one, pref[:, :-1]], dim=1)
    tnext = torch.cat([suf[:, 1:], one], dim=1)
    return field.mul(field.mul(pprev, tnext), inv)


def powers(root: int, count: int, scale: int, dev) -> torch.Tensor:
    """(16, count) Montgomery limbs of scale * root^k, k < count: two host
    lists of ~sqrt(count) powers and their outer product."""
    m = 1 << (((max(count, 1) - 1).bit_length() + 1) // 2)
    rows = -(-count // m)

    def host(r, n, s):
        out, cur = [], s % R_FR
        for _ in range(n):
            out.append(cur * (1 << 256) % R_FR)
            cur = cur * r % R_FR
        return FF.unpack(words_t(ints_to_words(out), dev))   # (16, n)

    lo = host(root, m, 1)
    hi = host(pow(root, m, R_FR), rows, scale)
    out = torch.empty((16, rows * m), dtype=torch.int64, device=dev)
    step = max(1, CHUNK // m)
    for r in range(0, rows, step):
        blk = hi[:, r:r + step]
        out[:, r * m:(r + blk.shape[1]) * m] = FR.mul(
            blk[:, :, None], lo[:, None, :]).reshape(16, -1)
    return out[:, :count]


def reduce_sums(acc: torch.Tensor, field) -> torch.Tensor:
    """(16, n) int64 limb-wise sums of canonical values (each sum below
    2^62) -> the canonical residues of the sums, CHUNK at a time."""
    out = torch.empty_like(acc)
    for lo in range(0, acc.shape[1], CHUNK):
        part = acc[:, lo:lo + CHUNK]
        pad = torch.zeros((4, part.shape[1]), dtype=acc.dtype,
                          device=acc.device)
        out[:, lo:lo + CHUNK] = field.reduce_wide(torch.cat([part, pad]))
    return out


def accumulate(src: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
               tgt: torch.Tensor, ntargets: int, field=FR) -> torch.Tensor:
    """sum over entries e with tgt[e] = t of mul(src[:, idx[e]],
    mont(vals[e])) for each target t < ntargets: src (16, X) limbs, idx
    and tgt (E,) int64, vals (E, 8) int32 plain words. A Montgomery src
    gives Montgomery sums, a plain one plain sums. Returns (16, ntargets)
    canonical limbs; entries are taken CHUNK at a time."""
    acc = torch.zeros((16, ntargets), dtype=torch.int64, device=src.device)
    for lo in range(0, idx.shape[0], CHUNK):
        v = field.to_mont(FF.unpack(vals[lo:lo + CHUNK]))
        acc.index_add_(1, tgt[lo:lo + CHUNK],
                       field.mul(src[:, idx[lo:lo + CHUNK]], v))
    return reduce_sums(acc, field)


def dot(a: torch.Tensor, b: torch.Tensor, field=FR) -> int:
    """sum_k mul(a_k, b_k) mod the field's modulus, as an int, for (16, n)
    limbs a and b (a Montgomery, b plain: the plain sum of products)."""
    total = 0
    for lo in range(0, a.shape[1], CHUNK):
        prod = field.mul(a[:, lo:lo + CHUNK], b[:, lo:lo + CHUNK])
        total += sum(int(v) << (16 * i) for i, v in
                     enumerate(prod.sum(dim=1).cpu().tolist()))
    return total % field.modulus
