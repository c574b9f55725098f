"""msms.gather_s: the port's span last_phases["msms.gather"], the sorted
points' gather (gather_cols), summed over the MSMs' slices and window
groups, on the card's clock (CUDA events), averaged over the traced
proofs; a --trace 0 run has no such span, since the port times it only
while a profiler records (seconds)."""

from benchmark.spans import traced


def read(run):
    return traced(run, "msms.gather")
