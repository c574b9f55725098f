"""msms.buckets_s: the port's span last_phases["msms.buckets"], the
boundary lookups (dma_gather), the telescoped difference, the halving
tree and the add into the running totals, summed over the MSMs' slices
and window groups, on the card's clock (CUDA events), averaged over the
traced proofs; a --trace 0 run has no such span, since the port times it
only while a profiler records (seconds)."""

from benchmark.spans import traced


def read(run):
    return traced(run, "msms.buckets")
