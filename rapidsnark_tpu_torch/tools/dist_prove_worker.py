"""One rank of a multi-process prove job.

    RSTPU_COORD=<host:port> RSTPU_NPROCS=<n> RSTPU_PROC_ID=<i> \
    python -m rapidsnark_tpu_torch.tools.dist_prove_worker \
        <zkey> <wtns> <outdir> <r> <s> [device] [backend]

Counterpart of `tools/dist_prove_worker.py`: the rank, the world size
and the rendezvous come from the environment knobs (parallel/multihost.
initialize); `device` is "cuda" (default: the rank's card) or "cpu",
`backend` defaults to NCCL on a card and gloo on the CPU. The rank
proves with the fixed (r, s) on the job's mesh and writes
proof_<rank>.json / public_<rank>.json into outdir; every rank must
write the same proof. It prints one JSON line: the rank's backend, its
share of the MSM points and of the domain, its slices and four-step
shape, its seconds by phase and its kernel launches.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional, Sequence


def prove_rank(zkey_path: str, wtns_path: str, outdir: str, r: int, s: int,
               device="cuda", backend: Optional[str] = None) -> dict:
    """Join the job, prove, write this rank's files, leave the job;
    returns the rank's summary (the printed line)."""
    from .. import device as D
    from ..io.wtns import read_wtns
    from ..io.zkey import read_zkey
    from ..parallel import multihost as MH
    from ..prover import Prover

    MH.initialize(device=device, backend=backend)
    try:
        mesh = MH.global_mesh(device)
        zkey = read_zkey(zkey_path)
        prover = Prover(zkey, mesh=mesh)
        zkey.close()
        D.reset_counts()
        proof, publics = prover.prove(read_wtns(wtns_path).values, r=r, s=s)
        counts = dict(D.counts)
    finally:
        MH.shutdown()
    rank = mesh.rank
    with open(os.path.join(outdir, f"proof_{rank}.json"), "w") as f:
        json.dump(proof.to_json_dict(), f)
    with open(os.path.join(outdir, f"public_{rank}.json"), "w") as f:
        json.dump([str(v) for v in publics], f)
    out = {**rank_summary(prover), "launches": counts,
           "proof": proof.to_json_dict()}
    prover.release()
    return out


def rank_summary(prover) -> dict:
    """A sharded Prover's rank: its backend and device, its share of the
    MSM points and slices, its four-step shape (None: the replicated NTT)
    and the last prove's seconds by phase."""
    from ..ops.glv import GLV_BITS
    mesh = prover.mesh
    local = prover.nmax // mesh.size
    seg = prover.segment
    plan = prover.dntt_plan
    return {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
            "device": str(mesh.device), "nmax": prover.nmax,
            "local_points": local, "segment": seg, "c_bits": prover.c_bits,
            "slices": 2 * local // seg if seg and seg < 2 * local else 1,
            "windows": -(-GLV_BITS // prover.c_bits),
            "four_step": None if plan is None else {
                "n1": plan.n1, "n2": plan.n2, "c2": plan.n2 // mesh.size,
                "local_domain": plan.n // mesh.size},
            "phases": prover.last_phases}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) not in (5, 6, 7):
        sys.stderr.write(__doc__)
        return 2
    out = prove_rank(argv[0], argv[1], argv[2], int(argv[3]), int(argv[4]),
                     *argv[5:])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
