"""msms.live_pct: the share of the MSMs' (point, window) entries whose
digit is nonzero, over the traced proofs: 100 * the port's counts
last_phases["count.msms.live"] / ["count.msms.entries"], each summed over
the five MSMs' window groups and the proofs. Entries of a zero digit are
sorted, gathered and scanned all the same today; a skip of them would
raise this towards 100. A --trace 0 run has no such counts, since the
port counts only while a profiler records (%)."""

from benchmark.spans import traced


def read(run):
    live = traced(run, "count.msms.live")
    entries = traced(run, "count.msms.entries")
    if live is None or not entries:
        return None
    return 100.0 * live / entries
