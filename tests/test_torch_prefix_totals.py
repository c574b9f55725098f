"""ops/fused.prefix_totals, the MSM's exclusive prefix of its chunk
totals, on the CPU (the plain version) against a sequential prefix on
the host (utils/hostcurve): equal after affine normalisation. Rows of
small multiples of the generator in projective form with random z (G1
coordinates also in the relaxed [0, 2p) range), with infinity, a
repeated point and a running sum that returns to infinity; four G1 rows,
one row on the G2 iso-twist."""

import random

import numpy as np
import pytest
import torch

from rapidsnark_tpu_torch.ops import fused
from rapidsnark_tpu_torch.ops.curve import G1P, G2P_ISO
from rapidsnark_tpu_torch.ref import field as F
from rapidsnark_tpu_torch.ref.curve import G1_GEN, G2_GEN
from rapidsnark_tpu_torch.utils.hostcurve import G1H, ProjGroup

torch.set_num_threads(1)

# y^2 = x^3 + (1 + 9i), the twist the G2 MSM scans on: b3 = 3 + 27i
G2H_ISO = ProjGroup(F.fq2_add, F.fq2_sub, F.fq2_mul, F.fq2_scalar,
                    F.fq2_inv, (0, 0), (1, 0), (3, 27))


def _iso_gen():
    w2, w3 = (tuple(F.FQ_CTX.from_mont(c) for c in G2P_ISO.iso[k])
              for k in ("w2", "w3"))
    return (F.fq2_mul(G2_GEN[0], w2), F.fq2_mul(G2_GEN[1], w3))


def _row(H, gen, nb, rng):
    """nb projective points: random multiples of gen with random z, one
    infinity, one repeat, and the negated sum of all before it."""
    pts = []
    for k in range(nb):
        p = H.mul(H.from_affine(gen), rng.randrange(1, 1 << 12))
        if k == 1:
            p = H.inf()
        elif k == nb // 2 and k > 2:
            p = pts[-1]
        elif k == nb - 1 and k > 4:
            acc = H.inf()
            for q in pts:
                acc = H.add(acc, q)
            p = H.neg(acc)
        pts.append(p)
    return pts


def _words(v: int):
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _encode(pts, g2, rng):
    """Projective points -> (n, L, 8) Montgomery words; z scaled by a
    random factor; G1 coordinates lifted by p where that stays below 2p."""
    out = []
    for x, y, z in pts:
        if g2:
            s = (rng.randrange(1, F.P), rng.randrange(F.P))
            coords = [F.fq2_mul(c, s) for c in (x, y, z)]
            flat = [c for pair in coords for c in pair]
        else:
            s = rng.randrange(1, F.P)
            flat = [c * s % F.P for c in (x, y, z)]
        mont = [F.FQ_CTX.to_mont(c) for c in flat]
        if not g2:
            mont = [m + F.P if rng.random() < 0.3 else m for m in mont]
        out.append([_words(m) for m in mont])
    return torch.from_numpy(np.array(out, dtype=np.uint32).view(np.int32))


def _affine(H, t: torch.Tensor, g2: bool):
    """(n, L, 8) words -> affine points (from_mont reduces mod p)."""
    res = []
    for pt in t.numpy().view(np.uint32):
        c = [F.FQ_CTX.from_mont(sum(int(w) << (32 * i)
                                    for i, w in enumerate(k))) for k in pt]
        if g2:
            c = [(c[0], c[1]), (c[2], c[3]), (c[4], c[5])]
        res.append(H.to_affine(tuple(c)))
    return res


@pytest.mark.parametrize("nb", [1, 3, 64, 100, 256, 257])
@pytest.mark.parametrize("g2", [False, True])
def test_prefix_totals_plain_matches_host_prefix(nb, g2):
    rng = random.Random(nb * 2 + g2)
    curve, H, gen, rows = ((G2P_ISO, G2H_ISO, _iso_gen(), 1) if g2
                           else (G1P, G1H, G1_GEN, 4))
    host = [_row(H, gen, nb, rng) for _ in range(rows)]
    L = 6 if g2 else 3
    tot = torch.stack([_encode(r, g2, rng) for r in host])
    assert tuple(tot.shape) == (rows, nb, L, 8)
    got = fused.prefix_totals(curve, tot)
    assert got.shape == tot.shape
    for r in range(rows):
        want, acc = [], H.inf()
        for p in host[r]:
            want.append(H.to_affine(acc))
            acc = H.add(acc, p)
        assert _affine(H, got[r], g2) == want
    if nb > 4:                     # the last total cancels the row
        assert H.to_affine(acc) is None
