"""device_idle_pct.warm: the card's idle share of the traced warm proofs
(benchmark/idle.py)."""

from benchmark.idle import pct


def read(run):
    return pct(run) if run.entry == "prove" else None
