"""front.upload_s: the port's span last_phases["front.upload"], the
witness's host-to-card copy, on the card's clock (CUDA events), averaged
over the traced proofs; a --trace 0 run has no such span, since the port
times it only while a profiler records (seconds)."""

from benchmark.spans import traced


def read(run):
    return traced(run, "front.upload")
