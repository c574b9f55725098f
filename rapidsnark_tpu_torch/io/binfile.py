"""iden3 binfile container (reader + writer).

Format (reference rapidsnark src/binfile_utils.cpp:34-60):
  4-byte magic type | u32 version | u32 nSections |
  repeated: u32 sectionType | u64 sectionSize | payload

The reader memory-maps the file and hands out zero-copy numpy views into
section payloads — the analogue of the reference's
mmap-then-keep-raw-pointers strategy (binfile_utils.cpp:19-32,
SURVEY.md §1 "zero-copy after one bulk read"), except we never copy the
file: device uploads read straight from the map.
"""

from __future__ import annotations

import mmap
import struct
from typing import Dict, List, Tuple

import numpy as np


class BinFile:
    def __init__(self, path: str, expected_type: str, max_version: int):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        buf = memoryview(self._mm)

        self.type = bytes(buf[0:4]).decode("latin1")
        if self.type != expected_type:
            raise ValueError(
                f"Invalid file type. It should be {expected_type} and it is {self.type}")
        (self.version,) = struct.unpack_from("<I", buf, 4)
        if self.version > max_version:
            raise ValueError(
                f"Invalid version. It should be <={max_version} and it is {self.version}")
        (n_sections,) = struct.unpack_from("<I", buf, 8)

        # section id -> list of (offset, size); multiple sections of one id
        # are legal in the container (binfile_utils.hpp Section vectors).
        self.sections: Dict[int, List[Tuple[int, int]]] = {}
        pos = 12
        for _ in range(n_sections):
            s_type, s_size = struct.unpack_from("<IQ", buf, pos)
            pos += 12
            self.sections.setdefault(s_type, []).append((pos, s_size))
            pos += s_size
        self._buf = buf

    def close(self):
        self._buf.release()
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def section_size(self, section_id: int, pos: int = 0) -> int:
        return self.sections[section_id][pos][1]

    def section_bytes(self, section_id: int, pos: int = 0) -> memoryview:
        off, size = self.sections[section_id][pos]
        return self._buf[off:off + size]

    def section_u8(self, section_id: int, pos: int = 0) -> np.ndarray:
        """Zero-copy uint8 view of a section payload."""
        off, size = self.sections[section_id][pos]
        return np.frombuffer(self._buf, dtype=np.uint8, count=size, offset=off)


def _pieces(payload) -> list:
    """A section payload (bytes, a C-contiguous numpy array, or a list of
    either) -> its byte views, written in turn."""
    items = payload if isinstance(payload, list) else [payload]
    return [memoryview(p).cast("B") if isinstance(p, np.ndarray)
            else memoryview(p) for p in items]


def write_binfile(path: str, magic: str, version: int,
                  sections: List[Tuple[int, object]]):
    """Write the container; each section's payload goes to the file
    piece by piece, never joined with another in memory."""
    assert len(magic) == 4
    with open(path, "wb") as f:
        f.write(magic.encode("latin1"))
        f.write(struct.pack("<II", version, len(sections)))
        for s_type, payload in sections:
            pieces = _pieces(payload)
            f.write(struct.pack("<IQ", s_type, sum(p.nbytes for p in pieces)))
            for p in pieces:
                f.write(p)
