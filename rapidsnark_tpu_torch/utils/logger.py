"""Phase-labeled logging (reference component §2.8, src/logger.{hpp,cpp}).

The reference ships a singleton pthread logger with levels
ERROR/ALARM/ALWAYS/INFO/BUFFER/TRACE/DEBUG, console or file sink
(`MyLogFile.log`), and runtime level switches. Python's logging module
already provides the machinery; this wraps it with the same knobs:

    RSTPU_LOG_LEVEL = error|info|trace|debug   (default info)
    RSTPU_LOG_FILE  = <path>                   (default: console)

`phase(name)` context manager emits the stage-boundary timeline the
reference gets from LOG_TRACE lines through prove() (groth16.cpp:51-202),
so phase timelines stay comparable. It is the port's one span: it adds
its seconds into a dict (a sink), and while spans are on (a torch
profiler records, or the level is trace) it is also a profiler range
named "rstpu.<name>", on the clock of the card's kernels in an exported
Chrome trace, and a span that names a CUDA device times the card's
stream by a pair of CUDA events instead of the host's clock. `collect`
gives the spans of a block that name no sink one to add into (the
Prover's last_phases for one prove) and reads their events once the
caller has synchronised. `count` adds into the same sink while spans are
on: a host number at once, a card tensor when the events are read.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import time

import torch

TRACE = 5
logging.addLevelName(TRACE, "TRACE")
# a span's profiler range is SPAN_PREFIX + its name
SPAN_PREFIX = "rstpu."

_LEVELS = {
    "error": logging.ERROR,
    "alarm": logging.CRITICAL,
    "always": logging.CRITICAL,
    "info": logging.INFO,
    "buffer": logging.DEBUG,
    "trace": TRACE,
    "debug": logging.DEBUG,
}

_logger = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        log = logging.getLogger("rapidsnark_tpu_torch")
        level = _LEVELS.get(os.environ.get("RSTPU_LOG_LEVEL", "info").lower(),
                            logging.INFO)
        log.setLevel(level)
        path = os.environ.get("RSTPU_LOG_FILE")
        handler = (logging.FileHandler(path) if path
                   else logging.StreamHandler())
        handler.setFormatter(logging.Formatter(
            "%(asctime)s.%(msecs)03d %(levelname)s %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S"))
        log.addHandler(handler)
        log.trace = lambda msg, *a: log.log(TRACE, msg, *a)  # type: ignore
        _logger = log
    return _logger


class Spans:
    """The spans of a `collect` block: the sink that spans naming none add
    into while spans are on, and their card event pairs not yet read."""

    def __init__(self, sink: dict):
        self.sink = sink
        self.pending: list = []
        self.counts: dict = {}     # name -> card tensors not yet read

    def read_card(self) -> None:
        """Add each pending event pair's card seconds, and each pending
        count, into its sink. Call after a synchronisation of the stream
        the events were recorded on: reading an event the card has not
        reached raises, and waiting for it here would add a
        synchronisation."""
        for sink, name, start, end in self.pending:
            sink[name] = sink.get(name, 0.0) + start.elapsed_time(end) / 1e3
        self.pending.clear()
        for name, vals in self.counts.items():
            self.sink[name] = (self.sink.get(name, 0)
                               + int(torch.stack(vals).sum()))
        self.counts.clear()


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("rstpu_spans",
                                                         default=None)


@contextlib.contextmanager
def collect(sink: dict):
    """Spans that name no sink add into `sink` while the block runs and
    spans are on; the block reads their card seconds with read_card()."""
    spans = Spans(sink)
    token = _ACTIVE.set(spans)
    try:
        yield spans
    finally:
        _ACTIVE.reset(token)


def _spans_on():
    """The enclosing `collect` block's Spans while spans are on, else
    None."""
    if torch.autograd.profiler._is_profiler_enabled or \
            get_logger().isEnabledFor(TRACE):
        return _ACTIVE.get()
    return None


def counting() -> bool:
    """Whether a `count` now adds anywhere: the caller skips the work of
    a count's value otherwise."""
    return _spans_on() is not None


def count(name: str, value) -> None:
    """Add `value` into the enclosing `collect` block's sink under `name`
    while spans are on, and nowhere otherwise: an int at once, a
    one-element tensor (on the card: no synchronisation) at read_card."""
    spans = _spans_on()
    if spans is None:
        return
    if isinstance(value, torch.Tensor):
        spans.counts.setdefault(name, []).append(value.reshape(()))
    else:
        spans.sink[name] = spans.sink.get(name, 0) + value


@contextlib.contextmanager
def phase(name: str, sink: dict | None = None, device=None):
    """Stage-boundary timeline marker (mirrors groth16.cpp LOG_TRACE) and
    span: sink[name] += the block's seconds. With no sink, the seconds go
    to the enclosing `collect` block's while spans are on, and nowhere
    otherwise. Spans are on while a torch profiler records (each span is
    then also the profiler range "rstpu.<name>") or the level is trace.
    A span on a CUDA `device` inside a `collect` block, spans on, is timed
    on the card by two CUDA events on the device's current stream, read
    by Spans.read_card; else by the host's clock."""
    log = get_logger()
    profiling = torch.autograd.profiler._is_profiler_enabled
    spans = _spans_on()
    if sink is None and spans is not None:
        sink = spans.sink
    card = (spans is not None and device is not None
            and torch.device(device).type == "cuda")
    log.log(TRACE, "%s begin", name)
    with (torch.profiler.record_function(SPAN_PREFIX + name) if profiling
          else contextlib.nullcontext()):
        if card:
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if card:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                spans.pending.append((sink, name, start, end))
            elif sink is not None:
                sink[name] = sink.get(name, 0.0) + dt
            log.log(TRACE, "%s end (%.3fs)", name, dt)
