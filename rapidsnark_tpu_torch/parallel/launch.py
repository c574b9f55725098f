"""Run a function on every rank of a job of spawned processes.

`run_ranks(fn, nranks, *args)` spawns `nranks` processes
(torch.multiprocessing, the spawn method), joins each to one job over a
file store (multihost.initialize), calls fn(mesh, *args) on every rank
and returns the results in rank order. The CLI's RSTPU_SHARD=1 runs one
rank per visible card this way; the CPU tests run gloo ranks with it.
`fn` and its arguments are pickled, so fn is a module-level function.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import torch.multiprocessing as mp

from . import multihost as MH


def _rank_main(rank: int, nranks: int, store: str, device, backend,
               fn: Callable, args: tuple, results) -> None:
    try:
        MH.initialize(num_processes=nranks, process_id=rank,
                      backend=backend, device=device,
                      init_method="file://" + store)
        try:
            out = fn(MH.global_mesh(device), *args)
        finally:
            MH.shutdown()
        # plain pickle bytes: a tensor put on the queue as it is would
        # travel as a shared-memory handle that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, nranks: int, *args, device="cuda",
              backend: Optional[str] = None,
              timeout: float = 3600.0) -> List:
    """fn(mesh, *args) on each of `nranks` spawned ranks on `device`
    (a card each: rank % the cards visible; or the CPU); the results in
    rank order. Raises RuntimeError with the rank's traceback if any rank
    fails, or if no result comes within `timeout` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, nranks, store, device, backend, fn,
                                   args, results))
                 for r in range(nranks)]
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = time.monotonic() + timeout
        try:
            # drain the queue before joining (a full pipe blocks a writer)
            while len(got) < nranks and not errors:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"ranks {dead} exited with codes "
                                      f"{[procs[r].exitcode for r in dead]}")
                    elif time.monotonic() > deadline:
                        errors.append(f"no result from every rank in "
                                      f"{timeout} s")
                    continue
                if ok:
                    got[rank] = pickle.loads(out)
                else:
                    errors.append(f"rank {rank}:\n{out}")
        finally:
            for p in procs:
                if errors:
                    p.terminate()
                p.join()
    if errors:
        raise RuntimeError("a rank failed: " + "\n".join(errors))
    return [got[r] for r in range(nranks)]
