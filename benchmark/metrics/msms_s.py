"""msms_s: the port's own span Prover.last_phases["msms"], averaged
over the window's proofs (seconds)."""


def read(run):
    vals = [r["phases"]["msms"] for r in run.ops if "msms" in r["phases"]]
    return sum(vals) / len(vals) if vals else None
