"""MSM phase ablation and the gather-layout microbench.

Counterpart of `tools/msm_ablate.py`. Times the whole ops/msm.msm on a
G1 table of B rows (4: the Prover's G1 call) and truncated variants of
its loop, slice by slice as the MSM runs them (every slice of the GLV
entry axis when `segment` cuts it, else the whole axis):

  msm            the whole MSM (window totals, combine=False)
  digits         the GLV split and every window's encoded signed digits
                 (ops/msm.glv_digits), and the phi image of the table
                 for the k2 slices (ops/msm.fq_scale)
  sort           + the bucket order of every window group
                 (ops/msm.digit_sort: a kernel on the card)
  gather         + ops/msm.gather_cols of every group (a kernel on the
                 card)
  scan_extract   digits + every group's scan and extraction with the
                 sort and the gather left out (the table in its own
                 order, the digits unsorted: the adders take the same
                 time whatever the values)

and, as separate plain stages in the same run, sort_plain and
gather_plain: the sort and gather stages with the plain versions
(torch.sort + searchsorted, advanced indexing), as the MSM ran them on
the card before the kernels; and, for one window group of one slice,
the gather formulations on the same rows (G x B x entries rows of 64
bytes), the plain gather_cols beside them:

  gather_cols         the MSM's gather straight into the scan's column
                      layout (the kernel)
  index_select_move   torch.index_select of the rows, then the move to
                      the column layout
  dma_gather          the port's hand-written row gather
                      (ops/fused.dma_gather) of the same rows
  dma_gather_move     dma_gather, then the move to the column layout

Tables and scalars are random residues from a seeded torch.Generator.

Usage: python -m rapidsnark_tpu_torch.tools.msm_ablate
           [logn] [reps] [segment] [c] [B] [G]
(segment 0: the whole axis; segment, c and the window group G by
default config.msm_plan's for B rows on this device's memory.)
"""

from __future__ import annotations

import sys

import torch

from .. import config, device as D
from ..ops import fused
from ..ops import glv as GLV
from ..ops import msm as MSM
from ..ops.curve import G1P
from ..ref.field import P, R_FR
from . import generator, random_words, timeit

C = 256   # columns of the scan's layout (ops/msm._CHUNK)


def main(argv=None, device=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    logn = int(argv[0]) if len(argv) > 0 else 20
    reps = int(argv[1]) if len(argv) > 1 else 3
    npts = 1 << logn
    B = int(argv[4]) if len(argv) > 4 else 4
    dev = D.resolve(device)
    plan = config.msm_plan(npts, B, 1, D.total_memory(dev))
    segment = int(argv[2]) if len(argv) > 2 else plan.segment
    c = int(argv[3]) if len(argv) > 3 else plan.c
    group = int(argv[5]) if len(argv) > 5 else plan.G
    gen = generator(dev, 5)
    pts = random_words((B, npts, 2), P, gen, dev)
    sc = random_words((B, npts), R_FR, gen, dev)
    params = GLV.params_for(G1P)
    nwin = -(-GLV.GLV_BITS // c)
    G = MSM.group_size(nwin, group)
    ngroups = nwin // G
    seg = segment if segment and segment < 2 * npts else 2 * npts
    M = 1 << (c - 1)

    def slices():
        """(entries, table part, digits of every window) a slice."""
        for off in range(0, 2 * npts, seg):
            if seg == 2 * npts:
                yield seg, MSM._table_slice(G1P, pts, 0, seg), \
                    MSM.glv_digits(sc, c, 0, nwin, params)
                continue
            offp = off % npts
            yield seg, MSM._table_slice(G1P, pts, off, seg), MSM.glv_digits(
                sc[:, offp:offp + seg], c, 0, nwin, params,
                half=int(off >= npts))

    def groups(dg):
        return (dg[ig * G:(ig + 1) * G] for ig in range(ngroups))

    def run_msm():
        return MSM.msm(G1P, pts, sc, c, group, segment=segment)

    def digits_only():
        return [dg.sum() for _, _, dg in slices()]

    def sort_only(sort=MSM.digit_sort):
        return [sort(g, c)[1].sum()
                for _, _, dg in slices() for g in groups(dg)]

    def sort_gather(sort=MSM.digit_sort, gather=MSM.gather_cols):
        out = []
        for _, part, dg in slices():
            for g in groups(dg):
                perm = sort(g, c)[1]
                out.append(gather(part, perm).sum())
        return out

    def scan_extract():
        out = []
        for n, part, dg in slices():
            nb = n // C
            cols = part.reshape(B, nb, C, 2, 8).movedim(2, 0)[:, None]
            cols = cols.expand((C, G, B, nb, 2, 8)).contiguous()
            for g in groups(dg):
                bshape = tuple(g.shape[:-1])
                sign = (g & 1).to(torch.int32).reshape(
                    bshape + (nb, C)).movedim(-1, 0).contiguous()
                within, excl = MSM._chunked_prefix(G1P, cols, sign, bshape,
                                                   nb)
                queries = 2 * torch.arange(M + 1, device=dev) + 1
                sd = g.reshape(-1, n)
                cum = torch.searchsorted(sd, queries.expand(
                    sd.shape[0], M + 1).contiguous(), right=True)
                A = MSM._ps_at(G1P, within, excl, cum.reshape(
                    bshape + (M + 1,)))
                top = A[..., M:, :, :].expand(bshape + (M, 3, 8))
                diff = fused.add(G1P, top.contiguous(),
                                 MSM.point_neg(G1P, A[..., :M, :, :]))
                out.append(MSM._tree_total(G1P, diff, M))
        return out

    variants = {"msm": run_msm, "digits": digits_only, "sort": sort_only,
                "gather": sort_gather, "scan_extract": scan_extract}
    stages = {k: timeit(fn, reps, dev) * 1e3 for k, fn in variants.items()}
    plain_stages = {
        "sort_plain": timeit(lambda: sort_only(MSM.digit_sort_plain), reps,
                             dev) * 1e3,
        "gather_plain": timeit(lambda: sort_gather(
            MSM.digit_sort_plain, MSM.gather_cols_plain), reps, dev) * 1e3}
    parts = stages["gather"] + stages["scan_extract"] - stages["digits"]
    print(f"G1 B={B} n=2^{logn} segment={segment} c={c} G={G} "
          f"({-(-2 * npts // seg)} slices x {ngroups} groups)")
    for k, v in {**stages, **plain_stages}.items():
        print(f"  {k:13s}: {v:10.3f} ms")
    print(f"  sum of parts : {parts:10.3f} ms vs msm {stages['msm']:.3f}")

    # the gather formulations, one group of one slice: G x B x seg rows
    gperm = torch.stack([torch.stack([torch.randperm(
        seg, generator=gen, device=dev) for _ in range(B)])
        for _ in range(G)]).to(torch.int32)                 # (G, B, seg)
    table = MSM._table_slice(G1P, pts, 0, seg) if seg == 2 * npts else \
        pts[:, :seg]
    rows = table.reshape(-1, 16)
    flat = (gperm + torch.arange(B, device=dev)[None, :, None] * seg)
    flat = flat.reshape(-1)
    flat32 = flat.to(torch.int32)
    nbg = seg // C

    def move(t):
        return t.reshape(G, B, nbg, C, 2, 8).movedim(3, 0).contiguous()

    gathers = {
        "gather_cols": lambda: MSM.gather_cols(table, gperm),
        "index_select_move": lambda: move(torch.index_select(rows, 0, flat)),
        "dma_gather": lambda: fused.dma_gather(rows, flat32),
        "dma_gather_move": lambda: move(fused.dma_gather(rows, flat32)),
    }
    ref = gathers["gather_cols"]()
    same = all(torch.equal(gathers[k](), ref)
               for k in ("index_select_move", "dma_gather_move")) and \
        torch.equal(MSM.gather_cols_plain(table, gperm), ref)
    del ref
    gb = rows.shape[1] * 4 * flat.shape[0] / 1e9
    gms = {k: timeit(fn, reps, dev) * 1e3 for k, fn in gathers.items()}
    gplain = timeit(lambda: MSM.gather_cols_plain(table, gperm), reps,
                    dev) * 1e3
    print(f"-- gather formulations: {G} x {B} x {seg} rows of 64 B, "
          f"equal {same}")
    for k, v in {**gms, "gather_cols_plain": gplain}.items():
        print(f"  {k:17s}: {v:10.4f} ms  {gb / v * 1e3:8.2f} GB/s")
    return {"device": str(dev), "logn": logn, "B": B, "segment": segment,
            "c": c, "G": G, "reps": reps, "stages_ms": stages,
            "plain_stages_ms": plain_stages,
            "sum_of_parts_ms": parts, "gather_ms": gms,
            "gather_plain_ms": gplain,
            "gather_equal": same, "gather_rows": flat.shape[0]}


if __name__ == "__main__":
    main()
