"""cold.io_s: what a cold prove spends outside the Prover: the
benchmark's span around the entry call less the Prover's set-up and
prove spans (for the CLI: the zkey and wtns reads and the proof.json /
public.json writes), averaged over the window."""


def read(run):
    vals = [r["t1"] - r["t0"] - sum(r["setup_phases"].values())
            - r["phases"]["total"] for r in run.ops if "setup_phases" in r]
    return sum(vals) / len(vals) if vals else None
