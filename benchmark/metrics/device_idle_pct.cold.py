"""device_idle_pct.cold: the card's idle share of the traced cold
proves, read and set-up included (benchmark/idle.py)."""

from benchmark.idle import pct


def read(run):
    return pct(run) if run.entry == "cli" else None
