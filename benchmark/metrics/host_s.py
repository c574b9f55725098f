"""host_s: the port's own span Prover.last_phases["host"], averaged
over the window's proofs (seconds)."""


def read(run):
    vals = [r["phases"]["host"] for r in run.ops if "host" in r["phases"]]
    return sum(vals) / len(vals) if vals else None
