"""The control and the faults, planted under a whole run at a tiny size,
make `correct` come out false: the control (a private witness word
changed under the port), a step that returns its state unchanged, and an
answer altered where it is produced; on the warm prove and on the CLI."""

from __future__ import annotations

import pytest

from cells import CLI, WARM, copy_with_tiny, run_cell


@pytest.mark.parametrize("mix,fault,number", [
    ("warm", "witness_word", "wrong_proofs"),
    ("warm", "stale", "wrong_proofs"),
    ("warm", "answer", "wrong_proofs"),
    ("cli", "witness_word", "unverified_proofs"),
    ("cli", "stale", "public_mismatch"),
    ("cli", "answer", "unverified_proofs"),
])
def test_fault_makes_the_run_incorrect(tmp_path, mix, fault, number):
    where = copy_with_tiny(str(tmp_path), {mix: WARM if mix == "warm"
                                           else CLI})
    # the first op is the warm-up's, so a stale window hands back an
    # answer for the other witness
    rc, out, err = run_cell(where, f"tiny.{mix}", seconds=0.1,
                            extra=("--fault", fault))
    assert rc == 0, err[-3000:]
    assert out["correct"] is False
    assert out["checks"][number]["value"] >= 1
    assert out["checks"][number]["limit"] == 0
