"""snarkjs .zkey and .wtns files of a key and a witness, for the cells
whose traffic reads its inputs from files. The layout is the one the
port reads (rapidsnark_tpu_torch/io/zkey.py, io/wtns.py; reference
rapidsnark src/zkey_utils.cpp, wtns_utils.cpp), written section by
section from the key's host arrays."""

from __future__ import annotations

import os
import struct

import numpy as np

from .frozen.ref_field import FQ_CTX, P, R_FR

COEF_DTYPE = np.dtype([("m", "<u4"), ("c", "<u4"), ("s", "<u4"),
                       ("coef", "<u4", (8,))])


def _fq(x: int) -> bytes:
    return FQ_CTX.to_mont(x).to_bytes(32, "little")


def _g1(pt) -> bytes:
    return b"\0" * 64 if pt is None else _fq(pt[0]) + _fq(pt[1])


def _g2(pt) -> bytes:
    if pt is None:
        return b"\0" * 128
    (x0, x1), (y0, y1) = pt
    return _fq(x0) + _fq(x1) + _fq(y0) + _fq(y1)


def _write(path: str, magic: str, version: int, sections) -> None:
    """The binary container: magic, version, section count, then each
    section's type, byte size and payload pieces."""
    with open(path, "wb") as f:
        f.write(magic.encode("latin1"))
        f.write(struct.pack("<II", version, len(sections)))
        for kind, pieces in sections:
            views = [memoryview(np.ascontiguousarray(p)).cast("B")
                     if isinstance(p, np.ndarray) else memoryview(p)
                     for p in pieces]
            f.write(struct.pack("<IQ", kind, sum(v.nbytes for v in views)))
            for v in views:
                f.write(v)
        # written back now, at set-up, not by the kernel's flusher inside
        # the window
        f.flush()
        os.fsync(f.fileno())


def write_zkey(path: str, key) -> None:
    vk = key.vk
    head = (struct.pack("<I", 32) + P.to_bytes(32, "little")
            + struct.pack("<I", 32) + R_FR.to_bytes(32, "little")
            + struct.pack("<III", key.n_vars, key.n_public, key.domain)
            + _g1(vk["alpha1"]) + _g1(vk["beta1"]) + _g2(vk["beta2"])
            + _g2(vk["gamma2"]) + _g1(vk["delta1"]) + _g2(vk["delta2"]))
    coefs = np.empty(key.coef_m.shape[0], COEF_DTYPE)
    coefs["m"], coefs["c"], coefs["s"] = key.coef_m, key.coef_c, key.coef_s
    coefs["coef"] = key.coef_val
    _write(path, "zkey", 1, [
        (1, [struct.pack("<I", 1)]), (2, [head]), (3, [key.ic]),
        (4, [struct.pack("<I", coefs.shape[0]), coefs]),
        (5, [key.points_a]), (6, [key.points_b1]), (7, [key.points_b2]),
        (8, [key.points_c]), (9, [key.points_h]), (10, [b""])])


def write_wtns(path: str, witness: np.ndarray) -> None:
    head = (struct.pack("<I", 32) + R_FR.to_bytes(32, "little")
            + struct.pack("<I", witness.shape[0]))
    _write(path, "wtns", 2, [(1, [head]),
                             (2, [witness.astype("<u4", copy=False)])])
