"""cold.prove_s: the first prove of each cold prove's new Prover, the
port's span Prover.last_phases["total"], averaged over the window."""


def read(run):
    vals = [r["phases"]["total"] for r in run.ops if "setup_phases" in r]
    return sum(vals) / len(vals) if vals else None
