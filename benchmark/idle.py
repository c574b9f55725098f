"""The card's idle share of a traced window: the part of the traced ops'
span (from the first op's start to the last op's end, on the trace's
clock) in which no kernel, copy or memset runs."""


def pct(run):
    t = run.traced
    if not t or "busy_s" not in t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
