"""front.acc_s: the port's span last_phases["front.acc"], the
coefficient accumulation (fr_slot_acc: the slot launches and any spill),
on the card's clock (CUDA events), averaged over the traced proofs; a
--trace 0 run has no such span, since the port times it only while a
profiler records (seconds)."""

from benchmark.spans import traced


def read(run):
    return traced(run, "front.acc")
