"""The general generator (generator.py) on a fake entry, no port: a
closed loop of one or two clients, open-loop arrivals at a fixed rate and
by a Poisson process drawn from the seed, and the mixes it refuses."""

from __future__ import annotations

import random
import time

import pytest

from benchmark import generator


class FakeInputs:
    witnesses = [0, 1]

    def __init__(self, seed: int = 7):
        self.seed = seed
        self._rs = random.Random(seed)

    def blinding(self):
        return self._rs.randrange(10), self._rs.randrange(10)

    def rng(self, what: str):
        return random.Random(f"{self.seed}:{what}")


class FakeEntry:
    def __init__(self, busy: float):
        self.busy = busy

    def op(self, i, widx, r, s):
        t0 = time.perf_counter()
        time.sleep(self.busy)
        return {"t0": t0, "t1": time.perf_counter(), "i": i, "widx": widx}


def test_closed_loop_one_client_starts_nothing_after_the_window():
    recs, window_s, failed = generator.drive(
        FakeEntry(0.02), FakeInputs(), {"loop": "closed", "witnesses": 2},
        0, seconds=0.1)
    assert not failed and len(recs) >= 2
    start = recs[0]["arrival"]
    assert all(r["t0"] < start + 0.1 for r in recs)
    assert recs[-1]["t1"] >= start + 0.1
    assert [r["widx"] for r in recs] == [i % 2 for i in range(len(recs))]
    assert window_s == pytest.approx(recs[-1]["t1"] - start)
    for a, b in zip(recs, recs[1:]):          # the next sent on the answer
        assert b["arrival"] == a["t1"]


def test_closed_loop_two_clients_queue_on_the_one_server():
    recs, _, _ = generator.drive(
        FakeEntry(0.01), FakeInputs(),
        {"loop": "closed", "clients": 2, "witnesses": 2}, 0, count=6)
    assert [r["client"] for r in recs] == [0, 1, 0, 1, 0, 1]
    assert recs[0]["arrival"] == recs[1]["arrival"]
    for k in range(2, 6):        # a client's next request waits its turn
        assert recs[k]["arrival"] == recs[k - 2]["t1"]
        assert recs[k]["t0"] >= recs[k - 1]["t1"]
    lat = [r["t1"] - r["arrival"] for r in recs[2:]]
    assert min(lat) >= 0.015               # its own op and the other's


def test_open_loop_fixed_rate_serves_what_arrived_in_the_window():
    mix = {"loop": "open", "rate_per_s": 50.0, "arrivals": "fixed",
           "witnesses": 2}
    recs, _, _ = generator.drive(FakeEntry(0.002), FakeInputs(), mix, 0,
                                 seconds=0.31)
    arr = [r["arrival"] for r in recs]
    assert len(recs) == 15
    assert all(b - a == pytest.approx(0.02) for a, b in zip(arr, arr[1:]))
    assert all(r["t0"] >= r["arrival"] for r in recs)
    assert all(r["client"] is None for r in recs)
    # overloaded: a request that arrived in the window is still served
    recs, _, _ = generator.drive(FakeEntry(0.05), FakeInputs(), mix, 0,
                                 seconds=0.09)
    assert len(recs) == 4 and recs[-1]["t0"] > recs[0]["arrival"] + 0.1


def test_open_loop_poisson_arrivals_come_from_the_seed():
    mix = {"loop": "open", "rate_per_s": 200.0, "witnesses": 2}

    def offsets(seed):
        recs, _, _ = generator.drive(FakeEntry(0.0), FakeInputs(seed), mix,
                                     0, count=20)
        return [r["arrival"] - recs[0]["arrival"] for r in recs]

    a, b, c = offsets(1), offsets(1), offsets(2)
    assert a == pytest.approx(b, abs=1e-9)
    assert a != pytest.approx(c, abs=1e-6)


@pytest.mark.parametrize("mix", [
    {"loop": "burst", "witnesses": 1},
    {"loop": "closed", "clients": 0, "witnesses": 1},
    {"loop": "open", "witnesses": 1},
    {"loop": "open", "rate_per_s": 1, "arrivals": "bursty", "witnesses": 1},
    {"loop": "closed"},
])
def test_mixes_the_generator_cannot_drive_are_refused(mix):
    assert generator.validate(mix)
