"""The port's own spans inside a prove, as the per-layer metrics read
them: the mean, over a run's records, of the sum of some keys of one of
the records' span dicts (Prover.last_phases as "phases", and
Prover.setup_phases). None where no record holds every key: a --trace 0
run, the other entry, or a port without those spans."""


def mean(records: list, table: str, keys: tuple):
    vals = [sum(r[table][k] for k in keys) for r in records
            if all(k in r.get(table, ()) for k in keys)]
    return sum(vals) / len(vals) if vals else None


def traced(run, *keys):
    """Over the traced proofs of a warm Prover (entry "prove"): the spans
    inside front and msms are on, and timed on the card, only while a
    profiler records."""
    if run.entry != "prove" or not run.traced:
        return None
    return mean(run.traced["records"], "phases", keys)


def window(run, table: str, *keys):
    """Over the window's cold proves (entry "cli"): the reads', the
    writes' and the set-up's spans are always on (host seconds)."""
    if run.entry != "cli":
        return None
    return mean(run.ops, table, keys)
