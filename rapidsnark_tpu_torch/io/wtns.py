"""snarkjs .wtns witness file reader and writer.

Format (reference rapidsnark src/wtns_utils.cpp:12-25):
  section 1: u32 n8, prime (n8 bytes LE), u32 nVars
  section 2: nVars * n8 bytes — witness values, little-endian,
             *standard* (non-Montgomery) form, used in place
             (main_prover.cpp:74).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..utils.limbs import bytes_to_words, NBYTES
from .binfile import write_binfile


@dataclass
class Wtns:
    n8: int
    prime: int
    n_vars: int
    values: np.ndarray  # (nVars, 8) uint32 WORDS (raw section-2
    # payload reinterpreted), standard form


def read_wtns(path: str) -> Wtns:
    from .native import open_binfile
    f = open_binfile(path, "wtns", 2)
    try:
        h = f.section_bytes(1)
        (n8,) = struct.unpack_from("<I", h, 0)
        prime = int.from_bytes(bytes(h[4:4 + n8]), "little")
        (n_vars,) = struct.unpack_from("<I", h, 4 + n8)
        # .copy(): bytes_to_words is a zero-copy view into the mapped
        # file, and this reader closes (unmaps) it before returning
        values = bytes_to_words(f.section_u8(2)).reshape(n_vars, 8).copy()
        return Wtns(n8=n8, prime=prime, n_vars=n_vars, values=values)
    finally:
        del h
        f.close()


def write_wtns(path: str, values: Sequence[int], prime: int | None = None):
    from ..ref.field import R_FR
    if prime is None:
        prime = R_FR
    sec1 = struct.pack("<I", NBYTES) + prime.to_bytes(NBYTES, "little")
    sec1 += struct.pack("<I", len(values))
    sec2 = b"".join((v % prime).to_bytes(NBYTES, "little") for v in values)
    write_binfile(path, "wtns", 2, [(1, sec1), (2, sec2)])
