"""cold_prove_s: the window's seconds over the cold proves it completed
(entry "cli": a new Prover each, from the zkey and wtns files to
proof.json / public.json written)."""


def read(run):
    if run.entry != "cli" or not run.ops:
        return None
    return run.window_s / len(run.ops)
