"""CLI prover with the reference's 4-argument contract
(main_prover.cpp:23-103): the same usage string and curve errors, exit
code 255 on any error, compact proof.json / public.json ("null" when the
circuit has no public signals).

    python -m rapidsnark_tpu_torch.cli <circuit.zkey> <witness.wtns> \
        <proof.json> <public.json>

Runs on the CUDA card. Sharded proving rides environment knobs, as in
the JAX package (the 4-argument contract stays as it is):

    RSTPU_NPROCS / RSTPU_PROC_ID / RSTPU_COORD
        this process is one rank of a multi-process job (every rank runs
        this same CLI with its own output paths and writes the same
        proof); see parallel/multihost.initialize
    RSTPU_SHARD=1
        one process shards over every visible card: one spawned rank a
        card, rank 0 writing the outputs; with one card, the unsharded
        prove
"""

from __future__ import annotations

import json
import sys
from typing import Optional, Sequence

from . import config
from .ref.field import R_FR

USAGE = ("Invalid number of parameters:\n"
         "Usage: prover <circuit.zkey> <witness.wtns> "
         "<proof.json> <public.json>\n")


def run_prove(zkey_path: str, wtns_path: str, proof_path: str,
              public_path: str, device="cuda",
              prover_out: Optional[list] = None, r: Optional[int] = None,
              s: Optional[int] = None) -> None:
    """Prove and write the two JSON artifacts. `prover_out`, when given,
    receives the Prover of this process: its last_phases hold, beside the
    prove's spans, the host seconds of the reads and writes (io.read_zkey,
    io.read_wtns, io.write). (r, s) go to Prover.prove (None: drawn
    there)."""
    import torch
    from . import device as D
    from .parallel import launch, multihost as MH

    if config.nprocs() or config.coordinator():
        MH.initialize(device=device)
        try:
            _prove(MH.global_mesh(device), zkey_path, wtns_path, proof_path,
                   public_path, device, prover_out, r=r, s=s)
        finally:
            MH.shutdown()
    elif config.shard() and D.resolve(device).type == "cuda" and \
            torch.cuda.device_count() > 1:
        launch.run_ranks(_spawned_rank, torch.cuda.device_count(),
                         zkey_path, wtns_path, proof_path, public_path, r, s,
                         device="cuda")
    else:
        _prove(None, zkey_path, wtns_path, proof_path, public_path, device,
               prover_out, r=r, s=s)


def _spawned_rank(mesh, zkey_path, wtns_path, proof_path, public_path, r,
                  s) -> None:
    """One rank of RSTPU_SHARD=1's job: the ranks share the output paths,
    so rank 0 writes them."""
    _prove(mesh, zkey_path, wtns_path, proof_path, public_path,
           device=mesh.device, write=mesh.rank == 0, r=r, s=s)


def _prove(mesh, zkey_path, wtns_path, proof_path, public_path, device,
           prover_out=None, write=True, r=None, s=None) -> None:
    """One process's prove (one rank's, with `mesh`)."""
    from .io.wtns import read_wtns
    from .io.zkey import read_zkey
    from .prover import Prover
    from .utils.logger import phase

    io = {}
    with phase("io.read_zkey", io):
        zkey = read_zkey(zkey_path)
    if zkey.r != R_FR:
        raise ValueError("zkey curve not supported")  # main_prover.cpp:47
    with phase("io.read_wtns", io):
        wtns = read_wtns(wtns_path)
    if wtns.prime != R_FR:
        raise ValueError("different wtns curve")      # main_prover.cpp:54
    prover = Prover(zkey, device=None if mesh else device, mesh=mesh)
    zkey.close()
    proof, publics = prover.prove(wtns.values, r, s)
    if write:
        with phase("io.write", io):
            with open(proof_path, "w") as f:
                f.write(json.dumps(proof.to_json_dict(),
                                   separators=(",", ":")))
            with open(public_path, "w") as f:
                pub = [str(v) for v in publics]
                f.write(json.dumps(pub, separators=(",", ":")) if pub
                        else "null")
    prover.last_phases.update(io)
    if prover_out is not None:
        prover_out.append(prover)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 4:
        sys.stderr.write(USAGE)
        return 255
    try:
        run_prove(*argv)
    except Exception as e:  # main_prover.cpp:97-101 catches everything
        sys.stderr.write(f"{e}\n")
        return 255
    return 0


if __name__ == "__main__":
    sys.exit(main())
