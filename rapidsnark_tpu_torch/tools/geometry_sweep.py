"""The measurements behind config.msm_plan, on one card.

  sweep   tools/sweep_msm (G1 on the Prover's four rows, and G2) at 2^24
          points for every slice of 2^19-2^23 entries and every (c, G)
          of CANDIDATES; each line with its time and its card peak
  whole   the same on whole axes of 2^8-2^21 points (segment 0), the c
          of a narrow axis
  prove   sqchain proves at 2^22, a wide 2^22 (983,040 extra wires),
          2^23 and 2^24 (K = 1 and, split in three, K = 3) under each
          geometry of PROVES (Prover arguments); two warm proves each
          with the fixed (r, s): last_phases and the stage peaks, every
          proof of a size byte-equal to the first, which pairing-verifies;
          and the front under RSTPU_NTT_SEQ=0 and 1 at 2^23 and 2^24

One JSON object a line into the output file (default
build/geometry_sweep.jsonl), the card's name and power limit on the
first. Fixtures are generated into bench_fixtures/ and deleted after
their size.

Usage: python -m rapidsnark_tpu_torch.tools.geometry_sweep
           [out.jsonl] [sweep,whole,prove]
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from .. import device as D, fixtures
from ..io.wtns import read_wtns
from ..io.zkey import read_zkey, zkey_to_ref
from ..prover import Prover
from ..ref.groth16 import verify
from . import card_line, sweep_msm

# (c, G): G = 5 cuts to 1 at c = 12 (11 windows) and to 3 at c = 15 (9)
CANDIDATES = ((12, 5), (13, 2), (13, 5), (14, 2), (14, 5), (15, 5),
              (16, 2), (16, 4), (16, 8))
WHOLE = {8: range(4, 11), 10: range(5, 12), 12: range(6, 13),
         14: range(7, 14), 16: range(8, 15), 18: range(10, 16),
         20: range(11, 17), 21: range(11, 17)}
# (segment, c, G) a prove runs under, by log2 of its domain; the first is
# the JAX package's geometry at that size
OLD = {22: (1 << 20, 13, 5), 23: (1 << 20, 13, 5), 24: (1 << 19, 13, 5)}
PROVES = {
    22: [OLD[22], (1 << 21, 13, 5), (1 << 22, 13, 5), (0, 13, 5),
         (1 << 22, 13, 2)],
    23: [OLD[23], (1 << 21, 13, 5), (1 << 22, 13, 5), (1 << 22, 13, 2),
         (1 << 23, 13, 2)],
    24: [OLD[24], (1 << 20, 13, 5), (1 << 21, 13, 5), (1 << 22, 13, 5),
         (1 << 22, 13, 2), (1 << 23, 13, 2), (1 << 21, 14, 5),
         (1 << 21, 16, 4), (1 << 22, 16, 2)],
}
K3 = [OLD[24], (1 << 21, 13, 5), (1 << 22, 13, 5), (1 << 22, 13, 2),
      (1 << 23, 13, 2)]
WIDE_EXTRA = 983_040
RS = (0x1234_5678_9ABC_DEF0 << 100 | 77, 0x0FED_CBA9_8765_4321 << 90 | 5)


class Out:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.f = open(path, "w")

    def put(self, **rec) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        self.f.write(line + "\n")
        self.f.flush()


def sweep(out: Out, logn: int, segments, configs) -> None:
    for seg in segments:
        for c, g in configs:
            try:
                res = sweep_msm.main(["both", str(logn), str(c), str(seg),
                                      "3", "4", str(g)], device="cuda")
                out.put(part="sweep", lines=res["lines"])
            except torch.OutOfMemoryError as e:
                out.put(part="sweep", logn=logn, segment=seg, c=c, G=g,
                        oom=str(e).splitlines()[0])
            torch.cuda.empty_cache()


def _proves(out: Out, tag: str, zk, wpath: str, geoms, want=None):
    """A first and two warm proves of zk under each geometry; returns the
    first proof, which pairing-verifies and every later one equals."""
    wt = read_wtns(wpath)
    for seg, c, g in geoms:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prover = Prover(zk, window_bits=c, window_group=g, segment=seg,
                        device="cuda")
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated()
        runs = []
        for _ in range(3):
            peaks = {}
            proof, pub = prover.prove(wt.values, r=RS[0], s=RS[1],
                                      peaks=peaks)
            runs.append({"phases": dict(prover.last_phases),
                         "peaks": peaks})
            if want is None:
                if not verify(zkey_to_ref(zk, tables=False), proof, pub):
                    raise RuntimeError(f"{tag}: the proof does not verify")
                want = proof
            elif (proof.a, proof.b, proof.c) != (want.a, want.b, want.c):
                raise RuntimeError(f"{tag} {(seg, c, g)}: the proof differs")
        out.put(part="prove", tag=tag, segment=prover.segment,
                c=prover.c_bits, G=prover.window_group, nmax=prover.nmax,
                ntt_seq=prover.ntt_seq, slots=prover.coef_slots,
                setup_s=setup_s, setup_peak=setup_peak,
                first=runs[0], warm=runs[1:])
        prover.release()
        del prover
    return want


def _ntt_seq(out: Out, tag: str, zk, wpath: str, geom) -> None:
    wt = read_wtns(wpath)
    seg, c, g = geom
    for flag in ("0", "1", "0", "1"):
        os.environ["RSTPU_NTT_SEQ"] = flag
        torch.cuda.empty_cache()
        prover = Prover(zk, window_bits=c, window_group=g, segment=seg,
                        device="cuda")
        runs = []
        for _ in range(3):
            peaks = {}
            prover.prove(wt.values, r=RS[0], s=RS[1], peaks=peaks)
            runs.append({"front": prover.last_phases["front"],
                         "total": prover.last_phases["total"],
                         "front_peak": peaks.get("front")})
        out.put(part="ntt_seq", tag=tag, ntt_seq=prover.ntt_seq,
                warm=runs[1:])
        prover.release()
        del prover
    del os.environ["RSTPU_NTT_SEQ"]


def prove_size(out: Out, fixdir: str, logn: int, extra: int = 0) -> None:
    tag = f"2^{logn}" + (f" wide +{extra}" if extra else "")
    t0 = time.perf_counter()
    zpath, wpath = fixtures.generate(logn, fixdir, device="cuda",
                                     extra=extra)
    out.put(part="fixture", tag=tag, seconds=time.perf_counter() - t0)
    zk = read_zkey(zpath)
    geoms = PROVES[logn] if not extra else \
        [OLD[22], (1 << 21, 13, 5), (1 << 22, 13, 5)]
    want = _proves(out, tag, zk, wpath, geoms)
    if logn >= 23 and not extra:
        _ntt_seq(out, tag, zk, wpath, OLD[logn])
    if logn == 24:
        zk3 = fixtures.split_thirds(zk, "cuda")
        torch.cuda.empty_cache()
        _proves(out, tag + " K=3", zk3, wpath, K3, want)
        del zk3
    zk.close()
    del zk
    os.remove(zpath)
    os.remove(wpath)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = argv[0] if argv else os.path.join(here, "build",
                                             "geometry_sweep.jsonl")
    parts = argv[1].split(",") if len(argv) > 1 else \
        ["sweep", "whole", "prove"]
    if not torch.cuda.is_available():
        raise SystemExit("geometry_sweep: no card")
    out = Out(path)
    out.put(part="card", card=card_line(),
            kind=torch.cuda.get_device_name(0),
            total_memory=torch.cuda.get_device_properties(0).total_memory,
            torch=torch.__version__, cuda=torch.version.cuda)
    D.build()
    t0 = time.perf_counter()
    if "sweep" in parts:
        sweep(out, 24, [1 << k for k in range(19, 24)], CANDIDATES)
        out.put(part="time", after="sweep", s=time.perf_counter() - t0)
    if "whole" in parts:
        for logn, cs in WHOLE.items():
            sweep(out, logn, [0], [(c, 5) for c in cs])
        out.put(part="time", after="whole", s=time.perf_counter() - t0)
    if "prove" in parts:
        for logn, extra in ((22, 0), (22, WIDE_EXTRA), (23, 0), (24, 0)):
            prove_size(out, os.path.join(here, "bench_fixtures"), logn,
                       extra)
        out.put(part="time", after="prove", s=time.perf_counter() - t0)
    out.f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
