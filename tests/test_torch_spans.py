"""The port's span (utils/logger.phase): off, it adds host seconds into
the sink it names and nothing else; on under a profiler, each span is a
"rstpu.<name>" range of the exported trace, nested as the spans are; on
a card (here a stand-in for CUDA's events), a span inside `collect` is
timed by an event pair read after the caller's synchronisation."""

import json
import logging

import pytest
import torch

from rapidsnark_tpu_torch.utils import logger as L

torch.set_num_threads(1)


@pytest.fixture
def level():
    """Set the port's log level for one test, restored after."""
    log = L.get_logger()
    old = log.level
    yield log.setLevel
    log.setLevel(old)


def _refused(*a, **k):
    raise AssertionError("a span made a profiler range or CUDA event")


def test_off_adds_host_seconds_and_nothing_else(monkeypatch, level):
    level(logging.INFO)
    monkeypatch.setattr(torch.profiler, "record_function", _refused)
    monkeypatch.setattr(torch.cuda, "Event", _refused)
    sink = {}
    with L.phase("a", sink):
        pass
    first = sink["a"]
    with L.phase("a", sink, device="cuda"):
        torch.ones(8).sum()
    assert sink["a"] > first > 0                  # accumulated
    into = {}
    with L.collect(into) as spans:
        with L.phase("b", device="cuda"):         # names no sink: nowhere
            pass
        spans.read_card()
    assert set(sink) == {"a"} and into == {} and spans.pending == []


def test_on_under_a_profiler_the_trace_holds_nested_ranges(tmp_path, level):
    level(logging.INFO)
    sink = {}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with L.collect(sink):
            with L.phase("outer", sink):
                with L.phase("outer.inner", device="cpu"):
                    torch.ones(8).sum()
                with L.phase("outer.inner"):
                    pass
        with L.phase("alone"):                    # no sink: a range only
            pass
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    assert len(spans["rstpu.outer.inner"]) == 2
    (olo, ohi), = spans["rstpu.outer"]
    assert all(olo <= lo and hi <= ohi
               for lo, hi in spans["rstpu.outer.inner"])
    assert "rstpu.alone" in spans
    assert set(sink) == {"outer", "outer.inner"}  # host seconds on the CPU
    assert sink["outer.inner"] <= sink["outer"]


class _Event:
    """A stand-in for torch.cuda.Event: its time is its record order
    (ms)."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = float(_Event.made)

    def elapsed_time(self, end):
        return end.t - self.t


def test_card_spans_are_event_pairs_read_after_the_sync(monkeypatch,
                                                        level):
    level(L.TRACE)                                # on without a profiler
    monkeypatch.setattr(torch.profiler, "record_function", _refused)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: None)
    sink = {}
    with L.collect(sink) as spans:
        for _ in range(2):
            with L.phase("msms.scan", device="cuda"):
                _Event(enable_timing=True)        # one more "ms" inside
        assert sink == {} and len(spans.pending) == 2
        spans.read_card()
    assert sink == {"msms.scan": pytest.approx(2 * 2e-3)}
    assert spans.pending == []
