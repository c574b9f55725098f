"""The witness's host-to-card copy, measured in its parts and whole.

Times, on the card, for a witness of `rows` rows of 32 B (random words
from a seed; default 16,776,961, a 2^24 sqchain's):
  pageable   the pageable `.to(card)` the prover used before the ring;
  pinned     one copy of the whole witness from a pinned buffer
             (the host link's rate), and of one chunk of each size;
  stage      the host's copy of the witness into a pinned slot, chunk by
             chunk: np.copyto (one thread), torch's copy_ with its
             intra-op threads and with one, and np.copyto split over a
             pool of 2, 4 and 8 threads;
  pin        torch.empty(pin_memory=True) of a slot: the first (pinning)
             and again after a free (the caching host allocator's);
  2^20       a 2^20 witness's pageable copy, and its Ring.upload by a
             new Ring each time, released after it;
  ring       utils/staging.copy_through at each chunk size and slot
             count of the sweep, and Ring.upload (the constants), from a
             writeable and from a read-only source, each checked word
             for word against the source.
Each time is the median of `reps` runs, host clock from the call to the
stream's end (a synchronisation). Prints one JSON line.

Usage: python -m rapidsnark_tpu_torch.tools.bench_upload [rows] [reps]
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils import staging as ST

MIB = 1 << 20
SWEEP_MIB = (8, 16, 32, 64, 128)
SWEEP_SLOTS = (2, 3)
SMALL_ROWS = 1_048_321          # a 2^20 sqchain's witness


def _timed(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return statistics.median(out)


def _card() -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return {"card": q.stdout.strip(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "cpus": os.cpu_count(),
            "torch_threads": torch.get_num_threads()}


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    rows = int(argv[0]) if argv else 16_776_961
    reps = int(argv[1]) if len(argv) > 1 else 5
    dev = torch.device("cuda")
    src = np.random.default_rng(1).integers(
        0, 1 << 32, size=(rows, 8), dtype=np.uint32)
    flat = src.reshape(-1).view(np.int32)
    nbytes = src.nbytes
    out = torch.empty(flat.size, dtype=torch.int32, device=dev)
    res = dict(_card(), rows=rows, bytes=nbytes, reps=reps)

    def gbs(s):
        return round(nbytes / s / 1e9, 3)

    pins = {}
    for mib in (32, 64):
        t = time.perf_counter()
        b = torch.empty(mib * MIB // 4, dtype=torch.int32, pin_memory=True)
        pins[f"{mib} MiB first"] = time.perf_counter() - t
        del b
        t = time.perf_counter()
        b = torch.empty(mib * MIB // 4, dtype=torch.int32, pin_memory=True)
        pins[f"{mib} MiB cached"] = time.perf_counter() - t
        del b
    res["pin_s"] = pins

    host = torch.from_numpy(flat)
    t = _timed(lambda: host.to(dev), reps)
    res["pageable"] = {"s": t, "GB/s": gbs(t)}

    pin = torch.empty(flat.size, dtype=torch.int32, pin_memory=True)
    pin.copy_(host)
    t = _timed(lambda: out.copy_(pin, non_blocking=True), reps)
    res["pinned"] = {"s": t, "GB/s": gbs(t), "chunk": {}}
    for mib in SWEEP_MIB:
        w = mib * MIB // 4
        t = _timed(lambda: out[:w].copy_(pin[:w], non_blocking=True), reps)
        res["pinned"]["chunk"][mib] = {"s": t, "GB/s": round(
            4 * w / t / 1e9, 3)}
    del pin

    chunk = 32 * MIB // 4
    slot = torch.empty(chunk, dtype=torch.int32, pin_memory=True)
    slot_np = slot.numpy()
    spans = [(a, min(a + chunk, flat.size)) for a in range(0, flat.size,
                                                           chunk)]

    def np_stage():
        for a, b in spans:
            np.copyto(slot_np[:b - a], flat[a:b])

    def torch_stage():
        for a, b in spans:
            slot[:b - a].copy_(host[a:b])

    stage = {"np.copyto": gbs(_timed(np_stage, reps)),
             "torch.copy_": gbs(_timed(torch_stage, reps))}
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stage["torch.copy_ 1 thread"] = gbs(_timed(torch_stage, reps))
    finally:
        torch.set_num_threads(nthreads)
    for T in (2, 4, 8):
        with ThreadPoolExecutor(T) as pool:
            def pool_stage():
                for a, b in spans:
                    cut = np.linspace(a, b, T + 1).astype(np.int64)
                    list(pool.map(lambda j: np.copyto(
                        slot_np[cut[j] - a:cut[j + 1] - a],
                        flat[cut[j]:cut[j + 1]]), range(T)))
            stage[f"np.copyto pool {T}"] = gbs(_timed(pool_stage, reps))
    res["stage_GB/s"] = stage
    del slot, slot_np

    ring = {}
    for S in SWEEP_SLOTS:
        for mib in SWEEP_MIB:
            plan = ST.chunk_plan(nbytes, mib * MIB)
            n = min(S, len(plan))
            slots = [torch.empty((plan[0][1] - plan[0][0]) // 4,
                                 dtype=torch.int32, pin_memory=True)
                     for _ in range(n)]
            events = [torch.cuda.Event() for _ in range(n)]
            t = _timed(lambda: ST.copy_through(out, flat, slots, events,
                                               plan), reps)
            ok = bool(torch.equal(out.cpu(), host))
            ring[f"S={S} B={mib}MiB"] = {"s": t, "GB/s": gbs(t),
                                        "chunks": len(plan), "equal": ok}
            del slots, events
    res["ring"] = ring

    r = ST.Ring()
    ro = src.copy()
    ro.flags.writeable = False
    for name, words in (("writeable", src), ("read-only", ro)):
        got = []
        t = _timed(lambda: got.append(r.upload(words, dev)), reps)
        dst = got[-1]
        res[f"Ring.upload {name}"] = {
            "s": t, "GB/s": gbs(t), "chunks": len(ST.chunk_plan(nbytes)),
            "B_MiB": ST.CHUNK_BYTES / MIB, "S": ST.SLOTS,
            "equal": bool(torch.equal(dst.cpu().view(-1), host))}
        del got, dst
    r.release()

    # a 2^20 witness (one chunk), a new Ring each upload, released after
    # it, as a new Prover a proof does
    small = src[:SMALL_ROWS]
    t = _timed(lambda: torch.from_numpy(small.reshape(-1).view(np.int32))
               .to(dev), reps)
    res["2^20 pageable"] = {"s": t}

    def fresh():
        ring = ST.Ring()
        ring.upload(small, dev)
        ring.release()
    res["2^20 Ring.upload"] = {"s": _timed(fresh, reps)}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
