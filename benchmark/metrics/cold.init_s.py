"""cold.init_s: the set-up of each cold prove's new Prover, the sum of
the port's own spans Prover.setup_phases, averaged over the window."""


def read(run):
    vals = [sum(r["setup_phases"].values()) for r in run.ops
            if "setup_phases" in r]
    return sum(vals) / len(vals) if vals else None
