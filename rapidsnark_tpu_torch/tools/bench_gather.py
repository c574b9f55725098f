"""Point-table gather formulations on the MSM's hot path.

Counterpart of `tools/bench_gather.py`. The sort + scan MSM gathers the
whole packed affine table once per window by a data-dependent
permutation (ops/msm.gather_cols) into the scan kernel's column layout
(256, n/256, A, 8). On a table of n G1 rows (64 bytes each) and a random
permutation this times:

  production  ops/msm.gather_cols, the MSM's gather straight into the
              column layout (in place of the TPU's lane-axis gather of
              limb-major leaves): a kernel on the card
  (plain)     ops/msm.gather_cols_plain, the advanced-index gather the
              MSM ran before the kernel, timed beside the cases
  take+move   torch.index_select on the (n, 16) rows, then the move to
              the column layout
  take only   the index_select alone (is the move or the gather the cost?)
  move only   the (n/256, 256, 16) -> (256, n/256, 16) move alone
  dma_gather  the hand-written row gather (ops/fused.dma_gather) on the
              same rows

Usage: python -m rapidsnark_tpu_torch.tools.bench_gather [logn] [reps] [K]

Each timing is the least of `reps` runs of K back-to-back calls, by CUDA
events after a warm-up. The JAX tool runs its K steps inside one jit and
perturbs the permutation every step, to amortise a remote fetch and to
defeat common-subexpression elimination; eager PyTorch has neither to
work around.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import device as D
from ..ops import fused
from ..ops import msm as MSM
from . import timeit

C = 256   # columns of the scan's layout (ops/msm._CHUNK)


def main(argv=None, device=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    logn = int(argv[0]) if len(argv) > 0 else 18
    reps = int(argv[1]) if len(argv) > 1 else 4
    K = int(argv[2]) if len(argv) > 2 else 8
    dev = D.resolve(device)
    n = 1 << logn
    if n % C:
        raise ValueError(f"bench_gather: 2^{logn} rows are under one chunk "
                         f"of {C}")
    rng = np.random.RandomState(0)
    perm_np = rng.permutation(n).astype(np.int32)
    rows_np = rng.randint(0, 2**31, size=(n, 16), dtype=np.int64).astype(
        np.uint32)
    rows = torch.from_numpy(rows_np.view(np.int32)).to(dev)     # (n, 16)
    pts = rows.view(n, 2, 8)                                    # G1 table
    perm32 = torch.from_numpy(perm_np).to(dev)
    perm = perm32.long()

    def move(t):
        return t.reshape(n // C, C, 16).movedim(1, 0).contiguous()

    cases = [
        ("production gather_cols ",
         lambda: MSM.gather_cols(pts, perm32[None])),
        ("row take + move        ",
         lambda: move(torch.index_select(rows, 0, perm))),
        ("row take only          ",
         lambda: torch.index_select(rows, 0, perm)),
        ("move only              ", lambda: move(rows)),
        ("dma_gather             ", lambda: fused.dma_gather(rows, perm32)),
    ]
    before = D.counts["dma_gather"]
    prod, moved, take, _, dma = (fn() for _, fn in cases)
    ok = bool(torch.equal(prod.reshape(C, n // C, 16), moved)
              and torch.equal(dma, take)
              and np.array_equal(take.cpu().numpy().view(np.uint32),
                                 rows_np[perm_np]))
    del prod, moved, take, dma
    print(f"correct: {ok}")
    gb = 16 * 4 * n / 1e9    # gathered payload per call (x and y packed)
    out = {"device": str(dev), "logn": logn, "reps": reps, "K": K,
           "correct": ok, "payload_gb": gb, "cases": {}}
    for name, fn in cases:
        dt = timeit(fn, reps, dev, calls=K)
        out["cases"][name.strip()] = {"ms": dt * 1e3, "gb_per_s": gb / dt}
        print(f"{name}: {dt*1e3:8.4f} ms/call  {gb/dt:8.2f} GB/s")
    dt = timeit(lambda: MSM.gather_cols_plain(pts, perm[None]), reps, dev,
                calls=K)
    out["plain"] = {"gather_cols_plain": {"ms": dt * 1e3,
                                          "gb_per_s": gb / dt}}
    print(f"plain gather_cols       : {dt*1e3:8.4f} ms/call  "
          f"{gb/dt:8.2f} GB/s")
    out["launches"] = D.counts["dma_gather"] - before
    return out


if __name__ == "__main__":
    main()
