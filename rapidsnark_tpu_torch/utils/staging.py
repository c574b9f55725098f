"""The witness's host-to-card copy through a ring of pinned staging
buffers.

A copy from pageable host memory runs at the rate at which CUDA stages
it through its own pinned bounce buffers, on one host thread: 5-6 GB/s
on an H100's host, against ~45 GB/s over the link from pinned memory
(PERF.md). Here the host copies each chunk of the caller's words into
one of SLOTS pinned buffers on torch's intra-op threads while the
card's copy engine drains the chunk before it, so an upload takes about
the slower of the two, plus one chunk. A slot is refilled only once the
card has passed the event recorded after its last copy. The buffers
come from torch's caching host allocator: a ring that is given back
(`Ring.release`) returns them there, and the next ring of that size in
the process reuses the pinned pages instead of pinning new ones. A
witness of at most one chunk takes a single slot of its own size.

CHUNK_BYTES and SLOTS come from the sweep of
`python -m rapidsnark_tpu_torch.tools.bench_upload` (PERF.md).
"""

from __future__ import annotations

import warnings
from typing import List, Tuple

import numpy as np
import torch

from .logger import count

ROW_BYTES = 32               # one witness value: 8 words
CHUNK_BYTES = 32 << 20       # B: a 2^20 witness is one chunk
SLOTS = 2                    # S


def chunk_plan(nbytes: int, chunk: int = CHUNK_BYTES
               ) -> List[Tuple[int, int]]:
    """The chunks of an upload of `nbytes` as [lo, hi) byte ranges, in
    order, of `chunk` bytes each but the last; every edge falls on a
    whole row."""
    if nbytes < 0 or nbytes % ROW_BYTES:
        raise ValueError(f"{nbytes} bytes is not a whole number of "
                         f"{ROW_BYTES}-byte rows")
    if chunk < ROW_BYTES or chunk % ROW_BYTES:
        raise ValueError(f"a chunk of {chunk} bytes is not a whole number "
                         f"of {ROW_BYTES}-byte rows")
    return [(lo, min(lo + chunk, nbytes)) for lo in range(0, nbytes, chunk)]


def copy_through(out: torch.Tensor, flat: np.ndarray,
                 slots: List[torch.Tensor], events: List[torch.cuda.Event],
                 plan: List[Tuple[int, int]]) -> None:
    """Copy the int32 words `flat` (host) into `out` (card) chunk by chunk
    of `plan`, chunk i through pinned slot i mod len(slots), on the card's
    current stream; `events[k]` marks slot k's last copy."""
    stream = torch.cuda.current_stream(out.device)
    with warnings.catch_warnings():
        # a read-only source: torch warns that it cannot protect it from
        # writes, and this only reads it
        warnings.simplefilter("ignore", UserWarning)
        host = torch.from_numpy(flat)
    for i, (lo, hi) in enumerate(plan):
        k = i % len(slots)
        events[k].synchronize()          # the slot's last copy is done
        a, b = lo // 4, hi // 4
        slot = slots[k][:b - a]
        slot.copy_(host[a:b])            # torch's intra-op threads
        out[a:b].copy_(slot, non_blocking=True)
        events[k].record(stream)


class Ring:
    """The pinned slots of one holder (a Prover), taken at its first
    upload and held until release()."""

    def __init__(self):
        self.slots: List[torch.Tensor] = []     # pinned int32 buffers
        self.events: List[torch.cuda.Event] = []  # each slot's last copy

    def _fit(self, words: int, nslots: int) -> None:
        if len(self.slots) == nslots and self.slots[0].numel() == words:
            return
        self.release()
        self.slots = [torch.empty(words, dtype=torch.int32, pin_memory=True)
                      for _ in range(nslots)]
        self.events = [torch.cuda.Event() for _ in range(nslots)]

    def upload(self, words: np.ndarray, device) -> torch.Tensor:
        """(n, 8) u32 words on the host -> the same bits as an (n, 8)
        int32 tensor on the card. The copies run on the device's current
        stream: work queued after this call on that stream sees the
        whole witness. The caller's array is only read, so a read-only
        (mapped) one is not copied first. While spans are on, the chunks
        staged add into count.front.staged (utils/logger.count)."""
        src = np.ascontiguousarray(words, dtype=np.uint32)
        plan = chunk_plan(src.nbytes)
        dst = torch.empty(src.shape, dtype=torch.int32, device=device)
        if plan:
            self._fit(plan[0][1] // 4, min(SLOTS, len(plan)))
            copy_through(dst.view(-1), src.reshape(-1).view(np.int32),
                         self.slots, self.events, plan)
        count("count.front.staged", len(plan))
        return dst

    def release(self) -> None:
        """Give the slots back to torch's caching host allocator, which
        holds each until the card has passed its last copy."""
        self.slots, self.events = [], []
