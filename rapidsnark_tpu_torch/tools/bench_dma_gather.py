"""The `dma_gather` kernel against torch.index_select on row-major rows.

Counterpart of `tools/bench_dma_gather.py`. The kernel
(ops/fused.dma_gather, csrc/gather.cu) gathers rows of a row-major
(n, R) table by a permutation with `nsem` 16-byte asynchronous copies in
flight per thread and `blk` rows a block; the tool checks it word for
word and prints its time, payload rate and row rate beside those of one
torch.index_select call on the same inputs, so the request rate can be
read as blk and nsem vary.

Usage: python -m rapidsnark_tpu_torch.tools.bench_dma_gather \\
           [logn] [rowwords] [blk] [nsem]

Timing is by CUDA events around eager calls after a warm-up. The JAX
tool loops K steps inside one jit with a perturbed permutation, to
amortise a remote fetch and to defeat common-subexpression elimination;
eager PyTorch has neither to work around.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import device as D
from ..ops import fused
from . import timeit

REPS = 4


def main(argv=None, device=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    logn = int(argv[0]) if len(argv) > 0 else 18
    R = int(argv[1]) if len(argv) > 1 else 16
    blk = int(argv[2]) if len(argv) > 2 else 512
    nsem = int(argv[3]) if len(argv) > 3 else 16
    dev = D.resolve(device)
    n = 1 << logn
    rng = np.random.RandomState(0)
    table_np = rng.randint(0, 2**31, size=(n, R), dtype=np.int64).astype(
        np.uint32)
    idx_np = rng.permutation(n).astype(np.int32)
    table = torch.from_numpy(table_np.view(np.int32)).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)

    before = D.counts["dma_gather"]
    got = fused.dma_gather(table, idx, blk=blk, nsem=nsem)
    ok = bool(np.array_equal(got.cpu().numpy().view(np.uint32),
                             table_np[idx_np]))
    print(f"correct: {ok}")
    gb = n * R * 4 / 1e9
    out = {"device": str(dev), "logn": logn, "rowwords": R, "blk": blk,
           "nsem": nsem, "correct": ok, "payload_gb": gb}
    idx64 = idx.long()
    for key, label, fn in (
            ("dma", f"dma  blk={blk} nsem={nsem}",
             lambda: fused.dma_gather(table, idx, blk=blk, nsem=nsem)),
            ("index_select", "torch index_select      ",
             lambda: torch.index_select(table, 0, idx64))):
        dt = timeit(fn, REPS, dev)
        out[key] = {"ms": dt * 1e3, "gb_per_s": gb / dt,
                    "mrows_per_s": n / dt / 1e6}
        print(f"{label}: {dt*1e3:8.4f} ms  {gb/dt:8.2f} GB/s"
              f"  {n/dt/1e6:8.1f} Mrows/s")
    out["launches"] = D.counts["dma_gather"] - before
    return out


if __name__ == "__main__":
    main()
