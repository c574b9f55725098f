"""msms.prep_s: the port's span last_phases["msms.prep"], the digits
(glv_digits) and the slice's phi image (fq_scale), summed over the MSMs'
slices and window groups, on the card's clock (CUDA events), averaged
over the traced proofs; a --trace 0 run has no such span, since the port
times it only while a profiler records (seconds)."""

from benchmark.spans import traced


def read(run):
    return traced(run, "msms.prep")
