"""cli.run_prove from the zkey and wtns files written at set-up to
proof.json / public.json, a new Prover each time, as the reference's
`prover` CLI proves (in this process: no interpreter start, import or
CUDA context a proof)."""

from __future__ import annotations

import json
import os
import time

import numpy as np

from . import plan_of
from .. import files
from ..reference import publics, verify


def affine_g1(words) -> tuple:
    """A (3, 8) Montgomery-words G1 point of the key, z = 1, -> affine
    ints (None for (0, 0))."""
    from ..frozen.ref_field import FQ_CTX
    x, y = (FQ_CTX.from_mont(int.from_bytes(
        np.ascontiguousarray(words[i], "<u4").tobytes(), "little"))
        for i in range(2))
    return None if x == y == 0 else (x, y)


def outputs(rec: dict) -> tuple:
    """(proof as affine ints, public signals) read back from the files the
    op wrote."""
    with open(rec["proof_path"]) as f:
        pj = json.load(f)
    with open(rec["public_path"]) as f:
        pub = json.load(f)
    a = tuple(int(v) for v in pj["pi_a"][:2])
    b = tuple(tuple(int(v) for v in pair) for pair in pj["pi_b"][:2])
    c = tuple(int(v) for v in pj["pi_c"][:2])
    return (a, b, c), [int(v) for v in (pub or [])]


class Entry:
    """The zkey and one wtns a witness are written into workdir at set-up;
    each op writes its own proof / public files."""

    def __init__(self, key, witnesses, dev, workdir):
        self.key, self.dev, self.workdir = key, dev, workdir
        self.zkey = os.path.join(workdir, "circuit.zkey")
        files.write_zkey(self.zkey, key)
        self.wtns = []
        for i, w in enumerate(witnesses):
            self.wtns.append(os.path.join(workdir, f"witness{i}.wtns"))
            files.write_wtns(self.wtns[-1], w)
        self.plan = None

    def op(self, i: int, widx: int, r, s) -> dict:
        from rapidsnark_tpu_torch import cli
        proof = os.path.join(self.workdir, f"proof{i}.json")
        public = os.path.join(self.workdir, f"public{i}.json")
        out = []
        t0 = time.perf_counter()
        cli.run_prove(self.zkey, self.wtns[widx], proof, public,
                      device=str(self.dev), prover_out=out)
        t1 = time.perf_counter()
        prover = out[0]
        self.plan = plan_of(prover)
        rec = {"t0": t0, "t1": t1, "widx": widx, "r": None, "s": None,
               "proof_path": proof, "public_path": public,
               "phases": dict(prover.last_phases),
               "setup_phases": dict(prover.setup_phases)}
        prover.release()
        return rec

    def check(self, inputs, ref, recs: list, sample: list) -> dict:
        """The CLI draws its own (r, s): every op's public.json against the
        witness's public signals, and the sampled ops' proof.json by
        Groth16's pairing check against the verifying key."""
        mism = unver = 0
        ic = [affine_g1(p) for p in self.key.ic]
        for j, rec in enumerate(recs):
            want = publics(inputs.witnesses[rec["widx"]], self.key.n_public)
            try:
                proof, pubs = outputs(rec)
            except (OSError, ValueError, KeyError, TypeError):
                proof = pubs = None          # no answer, or not a proof
            mism += pubs != want
            if j in sample and (proof is None
                                or not verify(self.key.vk, ic, proof, want)):
                unver += 1
        return {"public_mismatch": (mism, 0), "unverified_proofs": (unver, 0)}

    def gap_label(self, ts, start, end, card, rec) -> str:
        """By where the op's first and last card events fall: the program
        has no spans of its own around the reads and writes."""
        inside = [e for e in card if start <= e[2] <= end]
        if not inside or ts < inside[0][2]:
            return "read + set-up on the host"
        if ts > inside[-1][2] + inside[-1][3]:
            return "host assembly + write"
        return "set-up + prove"

    def close(self) -> None:
        pass
