"""Runtime knobs of the port (environment variables, as in the JAX
package), and the MSM's memory plan on the H100:

    RSTPU_WINDOW_BITS    Pippenger window size c (default: msm_plan's)
    RSTPU_WINDOW_GROUP   windows batched per MSM group (default:
                         msm_plan's)
    RSTPU_MSM_SEGMENT    entries per MSM bucket slice (default:
                         msm_plan's; 0: the whole axis)
    RSTPU_NTT_FUSE       0: per-stage NTT layers (ntt_tail from 2^12
                         points + one ntt_butterfly per other layer);
                         anything else: fused passes (default: fused at
                         every size, one pass a direction up to 2^10)
    RSTPU_NTT_SEQ        1/0: transform a, b, c one at a time / as one
                         stack (default: one at a time from 2^23)
    RSTPU_GLV            0: MSMs without the GLV split (ops/glv.enabled;
                         default on)
    RSTPU_NATIVE         0: the Python file reader; 1: require the native
                         reader (io/native.py; default: native when it
                         can be built)
    RSTPU_COORD          host:port of rank 0's rendezvous, and
    RSTPU_NPROCS         the ranks of a multi-process job, and
    RSTPU_PROC_ID        this process's rank (parallel/multihost.py;
                         every rank runs the same CLI)
    RSTPU_SHARD          1: the CLI spawns one rank per visible card
                         (default 0: one process, one card)
    RSTPU_PROFILE        a directory: Prover.prove writes a torch.profiler
                         trace of each prove there
    RSTPU_LOG_LEVEL      error|info|trace|debug (utils/logger; trace also
                         turns the spans inside a prove on), and
    RSTPU_LOG_FILE       the log's file (default: the console)

msm_plan sets the MSM's geometry (slice, c, window group) from the card's
memory and from MSM_COST, times measured on an H100 80GB HBM3
(tools/geometry_sweep; PERF.md). On one such card (85.0 GB) it gives
c = 16 from 2^18 points on, and (segment, G): whole axes with G = 8 at
2^20 and 2^21 points, slices of 2^22 entries with G = 8 at 2^22 and 2^23
points and with G = 4 at 2^24; smaller cards and ranks sharing a card
get narrower slices.
The Prover takes its arguments first, then the three variables above,
then the plan.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional


def int_env(name: str) -> Optional[int]:
    """The integer an environment variable holds; None when unset or
    empty."""
    v = os.environ.get(name)
    return int(v) if v else None


def window_bits() -> Optional[int]:
    return int_env("RSTPU_WINDOW_BITS")


def ntt_fuse(n: int) -> bool:
    """Whether an n-point transform runs as fused passes; the variable,
    when set, decides at every size. The default differs from the JAX
    package's (per stage below 2^12 points): the port runs a transform of
    up to 2^10 points as one pass a direction, where the per-stage path
    makes a launch a layer. A 1-point transform has no layer to run."""
    v = os.environ.get("RSTPU_NTT_FUSE")
    if v is not None:
        return v != "0"
    return n > 1


def ntt_sequential(power: int) -> bool:
    """Whether the front transforms a, b, c one at a time (a third of the
    NTT's temporaries) instead of as one stack; RSTPU_NTT_SEQ=1/0
    decides when set, else domains of 2^23 and more (the JAX package's
    rule, for HBM pressure beside the point tables on a TPU v5e)."""
    v = os.environ.get("RSTPU_NTT_SEQ")
    if v is not None:
        return v != "0"
    return power >= 23


# ---------------------------------------------------------------------------
# the MSM's memory plan on the H100
# ---------------------------------------------------------------------------

# torch.cuda.get_device_properties().total_memory of one H100 80GB HBM3:
# the memory a Prover on the CPU plans for, so its geometry is the card's
CARD_MEMORY = 85_017_493_504
# the share of a rank's part of the card that its point tables and one
# slice's working set may take; the rest holds the front, the coefficient
# tables, the scalar rows and a second circuit of the same size. Beside
# the tables and the slice, a 2^24 prove's G1 stage holds 7.6 / 10.0 GB
# more at K = 1 / 3 (the scalar rows and stack, the coefficient tables:
# PERF.md), so 35% of an 85 GB card keeps that stage within 40 GB
MSM_SHARE = 0.35
# candidates within this share of the cheapest cost as much (the sweep's
# spread); the smallest working set among them wins
PLAN_TIE = 0.02
# bytes of the resident point tables a point: a G1 row 64 (packed affine),
# the G2 row 128
TABLE_BYTES_G1_ROW, TABLE_BYTES_G2 = 64, 128
# the working set of a slice entry while ops/msm._window_group runs, from
# its code: per (window x table row) the largest of its three steps.
# digit_sort: its int64 input is the caller's; the sorted keys, the
# permutation and the signs (int32 each), the first radix pass's packed
# key and index (8 B) and its int32 workspace (ops/msm.sort_plan: a
# status word a digit of both passes a tile of 8192 keys, the counting
# pass's partial counts a chunk of 32768, 0.47 B a key at c = 16):
# 20.5 B. gather_cols: the permutation and the signs (the keys are
# dropped) and the gathered affine columns (A x 32 B): 8 + 32 A. The scan: the signs, the columns and the
# all-positions prefix `within` (L x 32 B): 4 + 32 A + 32 L, the largest;
# per table row the slice's digits of every window (int64) and its phi
# image (A x 32 B). G1: A 2, L 3; G2's iso-twist: A 4, L 6. PERF.md holds
# it against the card's peaks.
SLICE_BYTES_G1, SLICE_BYTES_G2 = 164, 324
ROW_BYTES_G1, ROW_BYTES_G2 = 64, 128
DIGIT_BYTES = 8
# log2 of a slice's entries -> its measured geometries, fastest first:
# (c, G, ns a GLV entry of the Prover's two MSMs: G1 on four rows, then
# G2), from tools/geometry_sweep on an H100 80GB HBM3 at 700 W: 2^24
# points in slices of 2^19-2^23 entries, whole axes below 2^19 entries
# (the fastest c there; c = 16 wins at every slice width)
MSM_COST = {
    9: ((9, 5, 34894.75),),
    11: ((9, 5, 9697.89),),
    13: ((9, 5, 2479.098),),
    15: ((9, 5, 616.431),),
    17: ((14, 5, 117.754),),
    19: ((16, 8, 34.172), (16, 4, 41.184), (16, 2, 70.194)),
    20: ((16, 8, 29.139), (16, 4, 30.168), (16, 2, 36.502)),
    21: ((16, 8, 24.416), (16, 4, 27.202), (16, 2, 28.331)),
    22: ((16, 8, 22.929), (16, 4, 23.578), (16, 2, 26.387)),
    23: ((16, 8, 21.951), (16, 4, 22.485), (16, 2, 23.169)),
}
# the narrowest slice: below 2^19 entries the times are whole axes', an
# MSM bound by its launches, which slicing would multiply
MIN_SLICE = 19
GLV_WINDOW_BITS = 128       # the bits of a GLV half (ops/glv.GLV_BITS)


class MSMPlan(NamedTuple):
    segment: int      # entries a slice; 0: the whole axis
    c: int            # window bits
    G: int            # windows scanned at once


def slice_bytes(c: int, G: int, rows: int = 4) -> int:
    """The working set of a slice entry at window bits c and window
    group G: the larger of the G1 MSM's on `rows` table rows and the G2
    MSM's on one."""
    digits = DIGIT_BYTES * -(-GLV_WINDOW_BITS // c)
    return max(rows * (G * SLICE_BYTES_G1 + digits + ROW_BYTES_G1),
               G * SLICE_BYTES_G2 + digits + ROW_BYTES_G2)


def msm_plan(npts: int, rows: int = 4, ranks: int = 1,
             memory: int = CARD_MEMORY) -> MSMPlan:
    """The MSM geometry of a rank whose axis holds `npts` points (a whole
    number of 256-point chunks), `rows` G1 table rows (4 in the Prover;
    its G2 MSM has one), `ranks` ranks sharing a card of `memory` bytes.

    A slice of 2^k entries (k >= MIN_SLICE) pads the axis to a whole
    number of slices (parallel/pmsm.pad_len_sharded); the whole axis is
    2 npts entries (GLV) and costs what MSM_COST gives the widest
    measured slice no wider. A candidate costs its padded entries times
    MSM_COST's time an entry, and fits when its point tables and its
    working set (entries x slice_bytes) are within MSM_SHARE of memory /
    ranks. Of the
    candidates that fit and cost within PLAN_TIE of the cheapest, the
    smallest working set wins. Raises ValueError when none fits."""
    budget = MSM_SHARE * memory / ranks
    per_point = rows * TABLE_BYTES_G1_ROW + TABLE_BYTES_G2
    widths = sorted(MSM_COST)
    cands = []
    for k in widths + [None]:
        if k is not None and k < MIN_SLICE and 1 << k < 2 * npts:
            continue
        if k is None or 1 << k >= 2 * npts:
            seg, nmax, ent = 0, npts, 2 * npts
            k = max([w for w in widths if 1 << w <= ent] or widths[:1])
        else:
            seg = 1 << k
            nmax, ent = -(-npts // seg) * seg, seg
        for c, g, ns in MSM_COST[k]:
            work = ent * slice_bytes(c, g, rows)
            if nmax * per_point + work <= budget:
                cands.append((2 * nmax * ns, work, MSMPlan(seg, c, g)))
        if seg == 0:
            break
    if not cands:
        raise ValueError(f"msm_plan: no MSM slice of {npts} points on "
                         f"{rows} G1 rows fits {MSM_SHARE} of "
                         f"{memory} / {ranks} bytes")
    least = min(cost for cost, _, _ in cands)
    return min((work, plan) for cost, work, plan in cands
               if cost <= least * (1 + PLAN_TIE))[1]


def coordinator() -> Optional[str]:
    return os.environ.get("RSTPU_COORD") or None


def nprocs() -> Optional[int]:
    return int_env("RSTPU_NPROCS") or None


def proc_id() -> Optional[int]:
    return int_env("RSTPU_PROC_ID")


def shard() -> bool:
    return os.environ.get("RSTPU_SHARD", "0") != "0"


def profile_dir() -> Optional[str]:
    return os.environ.get("RSTPU_PROFILE") or None
