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
  sort          digits + the bucket order (ops/msm.digit_sort: a kernel
                on the card)
  sort_plain    digits + its plain version (torch.sort, searchsorted,
                the sign columns), as the MSM ran it on the card before
                the kernel
  gather        sort + ops/msm.gather_cols (the scan's column layout, a
                kernel on the card)
  gather_plain  sort + its plain version (advanced indexing)
  scan          gather + the chunked prefix scan (scan_cols_packed, the
                chunk totals' prefix by add)
  group         digits + the whole window group (the boundary sums and
                the bucket tree too)

The differences between consecutive stages of the kernels' chain are
each stage's cost (deltas); the plain stages' own differences are beside
them (plain_deltas), read in the same run; a slice runs ceil(128/c)/G
groups. Tables and scalars are random residues
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

STAGES = ("digits", "digits_plain", "phi", "sort", "sort_plain", "gather",
          "gather_plain", "scan", "group")


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
        return MSM.digit_sort(digits(), c)

    def plus_sort_plain():
        return MSM.digit_sort_plain(digits(), c)

    def plus_gather():
        keys, perm, sign, _ = plus_sort()
        return keys, sign, MSM.gather_cols(pts, perm)

    def plus_gather_plain():
        _, perm, _, _ = plus_sort()
        return MSM.gather_cols_plain(pts, perm)

    def plus_scan():
        keys, sign, cols = plus_gather()
        bshape = tuple(keys.shape[:-1])
        return MSM._chunked_prefix(curve, cols, sign, bshape, nb)

    def group():
        return MSM._window_group(curve, pts, digits(), n, c)

    fns = {"digits": digits, "digits_plain": digits_plain, "phi": phi,
           "sort": plus_sort, "sort_plain": plus_sort_plain,
           "gather": plus_gather, "gather_plain": plus_gather_plain,
           "scan": plus_scan, "group": group}
    same = bool(torch.equal(digits(), digits_plain()))
    order_same = all(torch.equal(a, b) for a, b in zip(
        plus_sort(), plus_sort_plain())) and torch.equal(
            plus_gather()[2], plus_gather_plain())
    stages = {k: timeit(fn, reps, dev) * 1e3 for k, fn in fns.items()}
    deltas = {"digits": stages["digits"],
              "sort": stages["sort"] - stages["digits"],
              "gather": stages["gather"] - stages["sort"],
              "scan": stages["scan"] - stages["gather"],
              "extraction": stages["group"] - stages["scan"]}
    plain_deltas = {"sort": stages["sort_plain"] - stages["digits"],
                    "gather": stages["gather_plain"] - stages["sort"]}
    groups = nwin // G
    out = {"device": str(dev), "curve": which, "B": B, "logn": logn, "c": c,
           "G": G, "reps": reps, "digits_equal_plain": same,
           "order_equal_plain": order_same, "stages_ms": stages,
           "deltas_ms": deltas, "plain_deltas_ms": plain_deltas,
           "groups_per_slice": groups,
           "slice_estimate_ms": stages["group"] * groups + stages["phi"] / 2}
    print(f"{which} B={B} n=2^{logn} c={c} G={G}: digits equal the plain "
          f"composition: {same}; sort and gather equal their plain "
          f"versions: {order_same}")
    for k in STAGES:
        print(f"  {k:13s}: {stages[k]:10.4f} ms")
    for k, v in deltas.items():
        print(f"  delta {k:10s}: {v:10.4f} ms")
    for k, v in plain_deltas.items():
        print(f"  plain {k:10s}: {v:10.4f} ms")
    return out


if __name__ == "__main__":
    main()
