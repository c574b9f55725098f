"""The one general generator: it serves a traffic mix's requests through
the mix's entry, one at a time and in the order they arrive, as one
card's Prover (and rapidsnark's proverServer) serves them.

A mix (traffic/<mix>.json) sets:
  entry        entries/<entry>.py
  loop         "closed": `clients` clients (default 1), each with one
               request out, sending the next when its answer is back;
               "open": requests arrive at `rate_per_s` whatever the
               queue, spaced by `arrivals` ("poisson", the default, or
               "fixed"), the spacings drawn from the seed
  witnesses    how many witnesses the cell makes; request i proves
               witness i mod witnesses
  warmup_ops, traced_ops, check_sample
               read by the harness

Each record gets its request's `arrival` and `client` beside the entry's
own (t0, t1), so a latency is t1 - arrival, queueing included."""

from __future__ import annotations

import collections
import sys
import time

LOOPS = ("closed", "open")
SPACINGS = ("poisson", "fixed")


def validate(mix: dict) -> str:
    """Why the generator cannot drive this mix, or "" when it can."""
    if mix.get("loop") not in LOOPS:
        return f"loop is one of {LOOPS}"
    if mix["loop"] == "closed":
        c = mix.get("clients", 1)
        if not isinstance(c, int) or c < 1:
            return "a closed loop has a whole number of clients >= 1"
    else:
        if not mix.get("rate_per_s", 0) > 0:
            return "an open loop has rate_per_s > 0"
        if mix.get("arrivals", "poisson") not in SPACINGS:
            return f"arrivals is one of {SPACINGS}"
    if not isinstance(mix.get("witnesses"), int) or mix["witnesses"] < 1:
        return "witnesses is a whole number >= 1"
    return ""


def _spacings(mix: dict, rng):
    rate = float(mix["rate_per_s"])
    while True:
        if mix.get("arrivals", "poisson") == "poisson":
            yield rng.expovariate(rate)
        else:
            yield 1.0 / rate


def drive(entry, inputs, mix: dict, first: int, seconds: float = None,
          count: int = None, paced: bool = True, span=None):
    """Serve requests from the window's start: those that arrive before
    `seconds` have passed, every one of them answered, or the first
    `count`. Unpaced (the warm-up), requests follow one another back to
    back. span(j) wraps the j-th request's op (the traced window).
    Returns (records, seconds from the start to the last answer,
    failures)."""
    t_start = time.perf_counter()
    end = None if seconds is None else t_start + seconds
    open_loop = paced and mix["loop"] == "open"
    queue = collections.deque()        # (arrival, client) in arrival order
    if open_loop:
        gaps = _spacings(mix, inputs.rng("arrivals"))
        upcoming = t_start + next(gaps)
    else:
        clients = mix.get("clients", 1) if paced else 1
        queue.extend((t_start, c) for c in range(clients))
    recs, failed = [], []
    i = first
    while count is None or i - first < count:
        if open_loop:
            now = time.perf_counter()
            if not queue and (end is None or upcoming < end):
                time.sleep(max(0.0, upcoming - now))
                now = time.perf_counter()
            while upcoming <= now and (end is None or upcoming < end):
                queue.append((upcoming, None))
                upcoming += next(gaps)
        if not queue:
            break
        arrival, client = queue.popleft()
        widx = i % len(inputs.witnesses)
        r, s = inputs.blinding()
        try:
            if span is not None:
                with span(i - first):
                    rec = entry.op(i, widx, r, s)
            else:
                rec = entry.op(i, widx, r, s)
            rec["arrival"], rec["client"] = arrival, client
            recs.append(rec)
            done = rec["t1"]
        except Exception as e:            # a failed op counts, and is shown
            failed.append(f"op {i}: {type(e).__name__}: {e}")
            print(failed[-1], file=sys.stderr)
            done = time.perf_counter()
        if client is not None and (end is None or done < end):
            queue.append((done, client))      # its next request
        i += 1
    t_end = recs[-1]["t1"] if recs else time.perf_counter()
    return recs, t_end - t_start, failed
