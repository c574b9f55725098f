"""The MSM's phase split inside one window group of one slice.

Counterpart of `tools/bench_msm_phases.py`. Times sub-pipelines of
ops/msm._window_group that stop after each stage, at a slice's shape: B
table rows (4 for the Prover's G1 call, 1 for G2) of n entries, c-bit
windows in groups of G:

  digits        the GLV split of the k1 half and one group's encoded
                signed digits (ops/msm.glv_digits: a kernel on the card)
  digits_plain  the same by the plain composition (ops/glv.decompose,
                signed_digit_carries, group_signed_digits), as the MSM
                ran it on the card before the kernel
  phi           the slice's phi image of the table (ops/msm.fq_scale,
                once a slice of the k2 half)
  sort          digits + the stable sort
  gather        + ops/msm.gather_cols (the scan's column layout)
  scan          + the chunked prefix scan (scan_cols_packed, the chunk
                totals' prefix by add)
  group         digits + the whole window group (the boundary sums and
                the bucket tree too)

The differences between consecutive stages are each stage's cost; a
slice runs ceil(128/c)/G groups. Tables and scalars are random residues
from a seeded torch.Generator (the adders take the same time whatever
the values).

Usage: python -m rapidsnark_tpu_torch.tools.bench_msm_phases
           [logn] [c] [G] [reps] [g1|g2] [B]
"""

from __future__ import annotations

import sys

import torch

from .. import device as D
from ..ops import glv as GLV
from ..ops import msm as MSM
from ..ops.curve import G1P, G2P_ISO
from ..ref.field import P, R_FR
from . import generator, random_words, timeit

STAGES = ("digits", "digits_plain", "phi", "sort", "gather", "scan",
          "group")


def main(argv=None, device=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    logn = int(argv[0]) if len(argv) > 0 else 19
    c = int(argv[1]) if len(argv) > 1 else 13
    G = int(argv[2]) if len(argv) > 2 else 5
    reps = int(argv[3]) if len(argv) > 3 else 3
    which = argv[4] if len(argv) > 4 else "g1"
    B = int(argv[5]) if len(argv) > 5 else (4 if which == "g1" else 1)
    dev = D.resolve(device)
    n = 1 << logn
    if n % 256:
        raise ValueError(f"bench_msm_phases: 2^{logn} entries are under one "
                         "chunk of 256")
    curve = G1P if which == "g1" else G2P_ISO
    A = 2 if which == "g1" else 4
    params = GLV.params_for(curve)
    nwin = -(-GLV.GLV_BITS // c)
    G = min(G, nwin)
    while nwin % G:                       # as ops/msm.msm picks it
        G -= 1
    gen = generator(dev, 8)
    pts = random_words((B, n, A), P, gen, dev)
    sc = random_words((B, n), R_FR, gen, dev)
    nb = n // 256

    def digits():
        return MSM.glv_digits(sc, c, 0, G, params, half=0)

    def digits_plain():
        return MSM.glv_digits_plain(sc, c, 0, G, params, half=0)

    def phi():
        return MSM._phi(curve, pts)

    def plus_sort():
        return torch.sort(digits(), dim=-1, stable=True)

    def plus_gather():
        sd, perm = plus_sort()
        return sd, MSM.gather_cols(pts, perm)

    def plus_scan():
        sd, cols = plus_gather()
        bshape = tuple(sd.shape[:-1])
        sign = (sd & 1).to(torch.int32).reshape(bshape + (nb, 256)).movedim(
            -1, 0).contiguous()
        return MSM._chunked_prefix(curve, cols, sign, bshape, nb)

    def group():
        return MSM._window_group(curve, pts, digits(), n, c)

    fns = {"digits": digits, "digits_plain": digits_plain, "phi": phi,
           "sort": plus_sort, "gather": plus_gather, "scan": plus_scan,
           "group": group}
    same = bool(torch.equal(digits(), digits_plain()))
    stages = {k: timeit(fn, reps, dev) * 1e3 for k, fn in fns.items()}
    deltas = {"digits": stages["digits"],
              "sort": stages["sort"] - stages["digits"],
              "gather": stages["gather"] - stages["sort"],
              "scan": stages["scan"] - stages["gather"],
              "extraction": stages["group"] - stages["scan"]}
    groups = nwin // G
    out = {"device": str(dev), "curve": which, "B": B, "logn": logn, "c": c,
           "G": G, "reps": reps, "digits_equal_plain": same,
           "stages_ms": stages, "deltas_ms": deltas,
           "groups_per_slice": groups,
           "slice_estimate_ms": stages["group"] * groups + stages["phi"] / 2}
    print(f"{which} B={B} n=2^{logn} c={c} G={G}: digits equal the plain "
          f"composition: {same}")
    for k in STAGES:
        print(f"  {k:13s}: {stages[k]:10.4f} ms")
    for k, v in deltas.items():
        print(f"  delta {k:10s}: {v:10.4f} ms")
    return out


if __name__ == "__main__":
    main()
