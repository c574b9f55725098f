"""Prover.prove(witness, r, s) on one Prover built at set-up from the key
in memory, as a proof server (rapidsnark's proverServer) holds one."""

from __future__ import annotations

import time

from . import phase_label, plan_of, zkey_of
from ..reference import publics


class Entry:
    def __init__(self, key, witnesses, dev, workdir):
        from rapidsnark_tpu_torch.prover import Prover
        self.key, self.witnesses = key, witnesses
        self.prover = Prover(zkey_of(key), device=dev)
        self.plan = plan_of(self.prover)

    def op(self, i: int, widx: int, r: int, s: int) -> dict:
        t0 = time.perf_counter()
        proof, pubs = self.prover.prove(self.witnesses[widx], r, s)
        t1 = time.perf_counter()
        return {"t0": t0, "t1": t1, "widx": widx, "r": r, "s": s,
                "proof": (proof.a, proof.b, proof.c), "publics": pubs,
                "phases": dict(self.prover.last_phases)}

    def check(self, inputs, ref, recs: list, sample: list) -> dict:
        """Every op's proof against the reference's, point for point, and
        its public signals against the witness's."""
        wrong = 0
        for rec in recs:
            w = inputs.witnesses[rec["widx"]]
            want = (ref.proof(w, rec["r"], rec["s"]),
                    publics(w, self.key.n_public))
            wrong += (rec["proof"], rec["publics"]) != want
        return {"wrong_proofs": (wrong, 0)}

    def gap_label(self, ts, start, end, card, rec) -> str:
        return phase_label(ts, start, rec["phases"])

    def close(self) -> None:
        self.prover.release()
        self.prover = None
