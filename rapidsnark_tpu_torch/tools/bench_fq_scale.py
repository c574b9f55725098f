"""fq_scale at each of its callers' shapes, timed two ways.

The kernel (ops/msm.fq_scale, csrc/msm.cu k_fq_scale) scales packed Fq /
Fq2 coordinates by Montgomery constants or negates them. Its callers:
the phi image of the GLV table (a whole-axis prove's table, a sliced
prove's slice, 4 G1 rows and 1 G2 row, at config.msm_plan's geometry), a
window group's bucket negation (a strided view, G windows of 2^(c-1)
buckets), the G2 window totals' map back off the iso-twist, and
the G2 table's rescale onto it at set-up. Each case is held against
fq_scale_plain (word for word; the rescale in parts of 2^18 points) and
timed through its wrapper (CUDA events around `reps` calls after a
warm-up: what a caller waits for, host work included) and on the device
(`reps` calls in one CUDA graph, tools.device_time), beside the least
time the card could take (bytes read and written once over 3.35 TB/s,
or 264 IMADs a Montgomery product over 132 SMs x 64 a clock x 1.98 GHz;
an Fq2 product is 3).

Usage: python -m rapidsnark_tpu_torch.tools.bench_fq_scale [reps] [logn...]

(default 20 calls, 2^20 2^22 2^24). Prints one JSON line: the card, and
per case its key, whether it equals the plain version, wrapper ms,
device ms and the method, bound ms and what bounds it, and the device
ms of a copy of the same input (`clone`: the same bytes read and
written, no arithmetic; a memory-bound case's practical floor). On the CPU
(main(..., device="cpu")) the wrapper runs the plain version and no
device time is taken.
"""

from __future__ import annotations

import json
import sys

import torch

from .. import config
from .. import device as D
from ..ops import msm as MSM
from ..ops.curve import G1P, G2P, G2P_ISO
from ..ref.field import P
from . import (MONT_IMADS, bound_ms, card_line, device_time, generator,
               random_words, timeit)

PLAIN_PART = 1 << 18


def _plain_parts(t, spec, ext):
    """fq_scale_plain along the point axis (-3) in parts."""
    n = t.shape[-3]
    return torch.cat([MSM.fq_scale_plain(t[..., lo:lo + PLAIN_PART, :, :],
                                         spec, ext)
                      for lo in range(0, n, PLAIN_PART)], dim=-3)


def plan_geos(logns):
    """(label, points, config.msm_plan) of a prove of 2^logn points each."""
    return [(f"2^{ln}", 1 << ln, config.msm_plan(1 << ln)) for ln in logns]


def cases(words, geos):
    """Each caller's case, once for every shape: (key, tag, fn, plain,
    bytes, products, input). `geos` holds (label, points, (segment, c, G))
    of each prove; `words(shape, modulus)` draws random residues on the
    card. Tags are ("phi", labels, "g1" / "g2"), ("neg", c, G, grp),
    ("back", c), ("rescale", points); labels are the proves that run the
    phi case. Inputs are made as a case is reached and dropped with it."""
    iso = G2P_ISO.iso
    phis = {}
    for label, npts, (seg, c, grp_) in geos:
        sliced = bool(seg) and seg < 2 * npts
        n = seg if sliced else npts
        for grp, rows in (("g1", 4), ("g2", 1)):
            key = f"phi {grp} {rows} x 2^{n.bit_length() - 1}" + (
                f" a {label} slice" if sliced else f" the {label} table")
            phis.setdefault((grp, n, sliced), [key, rows, []])[2].append(
                label)
    for (grp, n, sliced), (key, rows, labels) in phis.items():
        curve, A = (G1P, 2) if grp == "g1" else (G2P_ISO, 4)
        table = words((rows, 2 * n if sliced else n, A), P)
        part = table[:, n:] if sliced else table
        nx = A // 2
        spec = (MSM.GLV.params_for(curve).beta_mont,) * nx + (None,) * nx
        yield (key, ("phi", tuple(labels), grp),
               lambda curve=curve, part=part: MSM._phi(curve, part),
               lambda part=part, spec=spec: MSM.fq_scale_plain(part, spec),
               2 * part.numel() * 4, rows * n * nx, part)
        del table, part
    cg = []
    for _, _, (_, c, grp_) in geos:
        G = MSM.group_size(-(-MSM.GLV.GLV_BITS // c), grp_)
        if (c, G) not in cg:
            cg.append((c, G))
    for c, G in cg:
        M = 1 << (c - 1)
        for grp, curve, L, op in (("g1", G1P, 3, "neg_rx"),
                                  ("g2", G2P_ISO, 6, "neg")):
            rows = 4 if grp == "g1" else 1
            buckets = words((G, rows, M + 1, L), P)
            head = buckets[..., :M, :, :]
            ext = 2 if grp == "g2" else 1
            yield (f"neg {grp} {G} x {rows} x {M} buckets (a view)",
                   ("neg", c, G, grp),
                   lambda curve=curve, head=head: MSM.point_neg(curve, head),
                   lambda head=head, op=op, ext=ext: MSM.fq_scale_plain(
                       head, (None, op, None), ext),
                   2 * head.numel() * 4, 0, head)
            del buckets, head
    for c in dict.fromkeys(c for c, _ in cg):
        nwin = -(-MSM.GLV.GLV_BITS // c)
        tot = words((nwin, 1, 6), P)
        yield (f"iso back {nwin} x 1 window totals", ("back", c),
               lambda tot=tot: MSM._iso_scale(G2P, tot, back=True),
               lambda tot=tot: MSM.fq_scale_plain(
                   tot, (iso["w2i"], iso["w3i"], None), 2),
               2 * tot.numel() * 4, nwin * 6, tot)
        del tot
    for npts in dict.fromkeys(npts for _, npts, _ in geos):
        tbl = words((1, npts, 4), P)
        yield (f"rescale the G2 table of {npts} points", ("rescale", npts),
               lambda tbl=tbl: MSM.g2_rescale_packed(tbl),
               lambda tbl=tbl: _plain_parts(tbl, (iso["w2"], iso["w3"]), 2),
               2 * tbl.numel() * 4, npts * 6, tbl)
        del tbl


def main(argv=None, device=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    reps = int(argv[0]) if argv else 20
    logns = tuple(int(a) for a in argv[1:]) or (20, 22, 24)
    dev = D.resolve(device)
    gen = generator(dev, 2026)
    on_card = dev.type == "cuda"
    lines = []
    for key, tag, fn, plain, nbytes, products, inp in cases(
            lambda shape, mod: random_words(shape, mod, gen, dev),
            plan_geos(logns)):
        equal = bool(torch.equal(fn(), plain()))
        ms = timeit(fn, 1, dev, calls=reps) * 1e3
        dms, method = device_time(fn, reps) if on_card else (None, None)
        copy_ms = device_time(inp.clone, reps)[0] if on_card else None
        b, by = bound_ms(nbytes, products * MONT_IMADS)
        lines.append({"case": key, "tag": list(tag), "equal": equal,
                      "ms": ms, "device_ms": dms, "method": method,
                      "bound_ms": b, "bound_by": by,
                      "device_share": None if dms is None else b / dms,
                      "copy_ms": copy_ms})
        if on_card:
            torch.cuda.empty_cache()
    out = {"device": torch.cuda.get_device_name(0) if on_card else "cpu",
           "card": card_line() if on_card else None, "reps": reps,
           "cases": lines}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
