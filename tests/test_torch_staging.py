"""The witness upload's chunk plan and ring order (utils/staging), on the
CPU. The copies themselves, through pinned slots to the card, are held
word for word by the card tests (tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

from rapidsnark_tpu_torch.utils import staging as ST

B = ST.CHUNK_BYTES
ROW = ST.ROW_BYTES


@pytest.mark.parametrize("nbytes", [
    B - 5 * ROW,               # smaller than a chunk
    B,                         # exactly one chunk
    3 * B,                     # k chunks
    3 * B + ROW,               # k chunks and one row
    ROW,                       # one row
    16_776_961 * ROW,          # the 2^24 sqchain's witness
    1_048_321 * ROW,           # the 2^20 one's
], ids=["under_B", "B", "kB", "kB_plus_row", "one_row", "d24", "d20"])
def test_chunk_plan_covers_the_witness_in_whole_rows(nbytes):
    plan = ST.chunk_plan(nbytes)
    assert len(plan) == -(-nbytes // B)
    assert plan[0][0] == 0 and plan[-1][1] == nbytes
    for (lo, hi), (nlo, _) in zip(plan, plan[1:] + [(nbytes, None)]):
        assert hi == nlo                        # in order, no gap, no overlap
        assert lo % ROW == 0 and hi % ROW == 0  # whole rows at every edge
        assert 0 < hi - lo <= B
    assert all(hi - lo == B for lo, hi in plan[:-1])


def test_chunk_plan_refuses_partial_rows():
    with pytest.raises(ValueError):
        ST.chunk_plan(B + 4)
    with pytest.raises(ValueError):
        ST.chunk_plan(B, chunk=ROW + 4)


class _Event:
    """A card event's stand-in: logs which slot was waited on and when
    its copy was recorded."""

    def __init__(self, k, log):
        self.k, self.log = k, log

    def synchronize(self):
        self.log.append(("wait", self.k))

    def record(self, stream):
        self.log.append(("record", self.k))


@pytest.mark.parametrize("nslots", [1, 2, 3])
def test_copy_through_waits_for_a_slot_before_refilling_it(nslots,
                                                           monkeypatch):
    """Chunk i goes through slot i mod S, each fill after a wait on the
    slot's last copy and each copy followed by its record, over two
    uploads back to back; the words arrive whole."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    rows = 37
    rng = np.random.default_rng(3)
    log = []
    slots = [torch.zeros(5 * 8, dtype=torch.int32) for _ in range(nslots)]
    events = [_Event(k, log) for k in range(nslots)]
    plan = ST.chunk_plan(rows * ROW, 5 * ROW)
    for _ in range(2):
        src = rng.integers(0, 1 << 32, size=(rows, 8), dtype=np.uint32)
        src.flags.writeable = False
        out = torch.zeros(rows * 8, dtype=torch.int32)
        ST.copy_through(out, src.reshape(-1).view(np.int32), slots, events,
                        plan)
        assert np.array_equal(out.numpy().view(np.uint32), src.reshape(-1))
    want = []
    for i in range(2 * len(plan)):
        want += [("wait", i % len(plan) % nslots),
                 ("record", i % len(plan) % nslots)]
    assert log == want
