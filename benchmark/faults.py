"""Faults planted under a run, for the control and for the tests that
show `correct` coming out false. Never used by a measured run: only
`python -m benchmark.run ... --fault <name>` plants one.

  witness_word  the control: every op proves its witness with one private
                wire's value changed (a guarantee broken: the proof is not
                the witness's)
  stale         a step that returns its state unchanged: every op after
                the first (a warm-up op) hands back the first op's answer
  answer        an answer altered where it is produced: the x coordinate
                of each proof's A, one added"""

from __future__ import annotations

import json

from . import files
from .frozen.ref_field import P

FAULTS = ("witness_word", "stale", "answer")


class _Faulty:
    def __init__(self, kind: str, entry, inputs):
        self.kind, self.entry, self.inputs = kind, entry, inputs
        self.first = None
        if kind == "witness_word":
            npub = inputs.key.n_public
            bent = []
            for w in inputs.witnesses:
                w = w.copy()
                w[npub + 1 + (w.shape[0] - npub - 1) // 2, 0] ^= 1
                bent.append(w)
            if hasattr(entry, "wtns"):
                for path, w in zip(entry.wtns, bent):
                    files.write_wtns(path, w)
            else:
                entry.witnesses = bent

    def __getattr__(self, name):
        return getattr(self.entry, name)    # plan, check, gap_label

    def op(self, i: int, widx: int, r: int, s: int) -> dict:
        rec = self.entry.op(i, widx, r, s)
        if self.first is None:
            self.first = rec
        elif self.kind == "stale":
            # the work is done, its answer dropped: the first op's stands
            keep = {k: v for k, v in self.first.items()
                    if k in ("proof", "publics", "proof_path",
                             "public_path")}
            rec = dict(rec, **keep)
        if self.kind == "answer":
            if "proof" in rec:
                a, b, c = rec["proof"]
                rec["proof"] = (((a[0] + 1) % P, a[1]), b, c)
            else:
                with open(rec["proof_path"]) as f:
                    pj = json.load(f)
                pj["pi_a"][0] = str((int(pj["pi_a"][0]) + 1) % P)
                with open(rec["proof_path"], "w") as f:
                    json.dump(pj, f)
        return rec

    def close(self) -> None:
        self.entry.close()


def wrap(kind: str, entry, inputs):
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}; one of {FAULTS}")
    return _Faulty(kind, entry, inputs)
