"""Window-size sweep of the MSM.

Counterpart of `tools/sweep_msm.py`: ops/msm.msm (window totals,
combine=False, GLV on) on G1 and G2 at 2^logn points for each c, one
line a configuration: curve, rows, c, windows, the window group the
MSM ran (G cut to a divisor of the windows), ms, points per second
and, on the card, the peak of allocated bytes over the timed calls
beside the bytes of the tables and scalars.
G1 runs `g1_rows` table rows at once (4 is the Prover's G1 call, 1 the
JAX tool's single MSM), G2 one row on the iso-twist. Tables and scalars
are random residues from a seeded torch.Generator (the adders take the
same time whatever the values).

Usage: python -m rapidsnark_tpu_torch.tools.sweep_msm
           [g1|g2|both] [logn] [c,c,...] [segment] [reps] [g1_rows] [G]
(segment 0: the whole axis; segment and G by default config.msm_plan's
for the G1 rows on this device's memory, printed beside each line.)
"""

from __future__ import annotations

import sys

import torch

from .. import config, device as D
from ..ops import glv as GLV
from ..ops import msm as MSM
from ..ops.curve import G1P, G2P
from ..ref.field import P, R_FR
from . import generator, random_words, timeit


def main(argv=None, device=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    which = argv[0] if len(argv) > 0 else "both"
    logn = int(argv[1]) if len(argv) > 1 else 18
    cs = [int(v) for v in argv[2].split(",")] if len(argv) > 2 else \
        [12, 13, 14, 15, 16]
    n = 1 << logn
    reps = int(argv[4]) if len(argv) > 4 else 2
    g1_rows = int(argv[5]) if len(argv) > 5 else 1
    dev = D.resolve(device)
    plan = config.msm_plan(n, g1_rows, 1, D.total_memory(dev))
    segment = int(argv[3]) if len(argv) > 3 else plan.segment
    group = int(argv[6]) if len(argv) > 6 else plan.G
    gen = generator(dev, 7)
    lines = []
    for curve_name in (["g1", "g2"] if which == "both" else [which]):
        curve, A, rows = ((G1P, 2, g1_rows) if curve_name == "g1"
                          else (G2P, 4, 1))
        pts = random_words((rows, n, A), P, gen, dev)
        sc = random_words((rows, n), R_FR, gen, dev)
        resident = (pts.numel() + sc.numel()) * 4
        for c in cs:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            dt = timeit(lambda: MSM.msm(curve, pts, sc, c, group,
                                        segment=segment), reps, dev)
            nwin = -(-GLV.GLV_BITS // c)
            line = {"curve": curve_name, "rows": rows, "logn": logn,
                    "segment": segment, "c": c, "G": group,
                    "G_ran": MSM.group_size(nwin, group), "windows": nwin,
                    "ms": dt * 1e3, "points_per_s": rows * n / dt,
                    "plan": plan._asdict(),
                    "resident_bytes": resident, "peak_bytes": (
                        torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None)}
            lines.append(line)
            print(f"{curve_name} x{rows} 2^{logn} segment={segment} c={c} "
                  f"W={nwin} G={line['G_ran']}: {dt * 1e3:.3f} ms  "
                  f"{rows * n / dt:,.0f} pts/s  peak {line['peak_bytes']} B"
                  f"  plan {tuple(plan)}", flush=True)
        del pts, sc
    return {"device": str(dev), "reps": reps, "lines": lines}


if __name__ == "__main__":
    main()
