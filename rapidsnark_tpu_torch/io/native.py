"""ctypes bridge to the native binfile loader (native/binfile.cpp).

Drop-in replacement for io.binfile.BinFile (same attribute surface:
sections / section_size / section_bytes / section_u8 / close), backed by
the C++ mmap loader with parallel prefault. Selection:

    RSTPU_NATIVE=0   force the pure-Python reader
    RSTPU_NATIVE=1   require the native reader (raise if unbuildable)
    unset            use native when the .so exists or g++ can build it

The .so is built on demand with `make -C native` and cached.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libbinfile.so")

_lib = None


def _build() -> bool:
    try:
        r = subprocess.run(["make", "-C", _NATIVE_DIR],
                           capture_output=True, timeout=120)
        return r.returncode == 0 and os.path.exists(_SO_PATH)
    except Exception:
        return False


def load_library() -> Optional[ctypes.CDLL]:
    global _lib
    mode = os.environ.get("RSTPU_NATIVE", "")
    if mode == "0":  # checked before the cache: the knob works mid-process
        return None
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH) and not _build():
        if mode == "1":
            raise RuntimeError("native binfile loader unavailable "
                               "(g++ build failed)")
        return None
    lib = ctypes.CDLL(_SO_PATH)
    lib.bf_open.restype = ctypes.c_void_p
    lib.bf_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                            ctypes.c_uint32, ctypes.c_int]
    lib.bf_last_error.restype = ctypes.c_char_p
    lib.bf_version.argtypes = [ctypes.c_void_p]
    lib.bf_version.restype = ctypes.c_uint32
    lib.bf_file_size.argtypes = [ctypes.c_void_p]
    lib.bf_file_size.restype = ctypes.c_uint64
    lib.bf_n_sections.argtypes = [ctypes.c_void_p]
    lib.bf_n_sections.restype = ctypes.c_int32
    lib.bf_section_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.bf_section_info.restype = ctypes.c_int32
    lib.bf_base.argtypes = [ctypes.c_void_p]
    lib.bf_base.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.bf_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeBinFile:
    """io.binfile.BinFile API over the C++ loader."""

    def __init__(self, path: str, expected_type: str, max_version: int,
                 prefault_threads: int = 8):
        lib = load_library()
        assert lib is not None
        self._lib = lib
        self.path = path
        h = lib.bf_open(path.encode(), expected_type.encode(),
                        max_version, prefault_threads)
        if not h:
            raise ValueError(lib.bf_last_error().decode())
        self._h = ctypes.c_void_p(h)
        self.version = lib.bf_version(self._h)
        size = lib.bf_file_size(self._h)
        base = lib.bf_base(self._h)
        self._buf = np.ctypeslib.as_array(base, shape=(size,))  # zero-copy

        self.sections: Dict[int, List[Tuple[int, int]]] = {}
        t = ctypes.c_uint32()
        off = ctypes.c_uint64()
        sz = ctypes.c_uint64()
        for i in range(lib.bf_n_sections(self._h)):
            lib.bf_section_info(self._h, i, ctypes.byref(t),
                                ctypes.byref(off), ctypes.byref(sz))
            self.sections.setdefault(int(t.value), []).append(
                (int(off.value), int(sz.value)))

    def close(self):
        if self._h:
            # neutralize the view FIRST: any section_u8/section_bytes
            # use after close raises (AttributeError/TypeError) instead
            # of silently reading unmapped memory. Arrays handed out
            # earlier still dangle — callers must drop them before
            # closing (io/zkey.py ZKey.close does).
            self._buf = None
            self._lib.bf_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def section_size(self, section_id: int, pos: int = 0) -> int:
        return self.sections[section_id][pos][1]

    def section_bytes(self, section_id: int, pos: int = 0):
        off, size = self.sections[section_id][pos]
        return memoryview(self._buf[off:off + size])

    def section_u8(self, section_id: int, pos: int = 0) -> np.ndarray:
        off, size = self.sections[section_id][pos]
        return self._buf[off:off + size]


def open_binfile(path: str, expected_type: str, max_version: int):
    """Native loader when available, Python mmap reader otherwise."""
    if load_library() is not None:
        return NativeBinFile(path, expected_type, max_version)
    from .binfile import BinFile
    return BinFile(path, expected_type, max_version)
