"""prove_s: the window's seconds over the proofs it completed, for a
warm Prover (entry "prove"): from the window's start to the end of its
last proof, which starts inside --seconds; a proof runs from the witness
handed over on the host to the proof back on the host."""


def read(run):
    if run.entry != "prove" or not run.ops:
        return None
    return run.window_s / len(run.ops)
