# Frozen copy of rapidsnark_tpu_torch/utils/limbs.py at commit 6caa3f5 for the benchmark's yardstick.
# Unchanged.
"""Host-side limb and word conversions (numpy).

A 256-bit field element is 16 little-endian 16-bit limbs (the plain torch
field layout, ops/field.py) or 8 little-endian u32 words (the zkey/wtns
payload and the CUDA kernels' layout). This replaces ffiasm's
4 x 64-bit RawFr::Element layout (SURVEY.md §2.12).
"""

from __future__ import annotations

import numpy as np

NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
NBYTES = 32


def int_to_limbs(x: int) -> np.ndarray:
    """Single int -> (16,) uint32 limbs."""
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(NLIMBS)],
                    dtype=np.uint32)


def limbs_to_int(l) -> int:
    """(16,) limbs -> int."""
    return sum(int(l[i]) << (LIMB_BITS * i) for i in range(NLIMBS))


def ints_to_limbs(xs) -> np.ndarray:
    """Iterable of ints -> (n, 16) uint32."""
    out = np.empty((len(xs), NLIMBS), dtype=np.uint32)
    for i, x in enumerate(xs):
        for j in range(NLIMBS):
            out[i, j] = (x >> (LIMB_BITS * j)) & LIMB_MASK
    return out


def limbs_to_ints(a) -> list:
    a = np.asarray(a, dtype=np.uint64)
    flat = a.reshape(-1, NLIMBS)
    return [sum(int(row[i]) << (LIMB_BITS * i) for i in range(NLIMBS))
            for row in flat]


NWORDS = 8


def bytes_to_words(buf: bytes | np.ndarray) -> np.ndarray:
    """Little-endian 32-byte field elements -> (n, 8) uint32 WORDS — a
    pure reinterpretation of the on-disk bytes (the packed wire format
    the device pipeline consumes; ops/msm.pack_limb_rows of the 16-limb
    form equals exactly these words)."""
    u8 = (np.frombuffer(buf, dtype=np.uint8)
          if isinstance(buf, (bytes, bytearray, memoryview))
          else np.asarray(buf, dtype=np.uint8))
    assert u8.size % NBYTES == 0
    if not u8.flags["C_CONTIGUOUS"]:
        u8 = np.ascontiguousarray(u8)
    return u8.view("<u4").reshape(-1, NWORDS)


def words_to_ints(arr) -> list:
    """(..., 8) uint32 words -> list of ints."""
    a = np.asarray(arr, dtype=np.uint64)
    flat = a.reshape(-1, NWORDS)
    return [sum(int(row[i]) << (32 * i) for i in range(NWORDS))
            for row in flat]


def ints_to_words(xs) -> np.ndarray:
    """Iterable of ints -> (n, 8) uint32 words."""
    out = np.empty((len(xs), NWORDS), dtype=np.uint32)
    for i, x in enumerate(xs):
        for j in range(NWORDS):
            out[i, j] = (x >> (32 * j)) & 0xFFFFFFFF
    return out


def bytes_to_limbs(buf: bytes | np.ndarray) -> np.ndarray:
    """Little-endian 32-byte field elements -> (n, 16) uint32 limbs.

    Zero-copy-ish: one u16 view + one widening cast. This is how zkey /
    wtns section payloads (32-byte LE integers, SURVEY.md §2.4-2.5) enter
    the device format.
    """
    u8 = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray, memoryview)) else np.asarray(buf, dtype=np.uint8)
    assert u8.size % NBYTES == 0
    u16 = u8.view("<u2").reshape(-1, NLIMBS)
    return u16.astype(np.uint32)


def limbs_to_bytes(a: np.ndarray) -> bytes:
    """(n, 16) uint32 limbs -> little-endian 32-byte-per-element buffer."""
    a = np.asarray(a, dtype=np.uint32).reshape(-1, NLIMBS)
    return a.astype("<u2").tobytes()
