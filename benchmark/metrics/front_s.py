"""front_s: the port's own span Prover.last_phases["front"], averaged
over the window's proofs (seconds)."""


def read(run):
    vals = [r["phases"]["front"] for r in run.ops if "front" in r["phases"]]
    return sum(vals) / len(vals) if vals else None
