"""snarkjs .zkey (Groth16 proving key) reader and writer.

Section layout (reference rapidsnark src/zkey_utils.cpp:17-51 and
main_prover.cpp:67-72):
  1: protocol id (u32, must be 1 = groth16)
  2: n8q, q, n8r, r, nVars, nPublic, domainSize,
     vk_alpha1 (G1), vk_beta1 (G1), vk_beta2 (G2), vk_gamma2 (G2),
     vk_delta1 (G1), vk_delta2 (G2)
  3: IC points (nPublic+1 G1) — verifier side
  4: coefficients: u32 count, then records {u32 m, u32 c, u32 s, Fr coef}
     (the reference skips the leading count with a +4, groth16.cpp:38;
      nCoefs = sectionSize / (12 + n8r), zkey_utils.cpp:49)
  5: pointsA (nVars G1)    6: pointsB1 (nVars G1)
  7: pointsB2 (nVars G2)   8: pointsC (nVars-nPublic-1 G1)
  9: pointsH (domainSize G1)
  10: contributions (opaque, unused by the prover)

All group coordinates and coefficient values are Montgomery-form
(R = 2^256) little-endian 32-byte integers; G1 = x||y, G2 =
x.c0||x.c1||y.c0||y.c1 (ffiasm F2Field a+b*i ordering). Infinity is
encoded as all-zero coordinates.

The reader returns numpy limb arrays (n, k, 16) uint32 ready for device
upload — points stay in Montgomery form and are used in place, matching
the reference's zero-deserialization strategy (SURVEY.md §1).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..utils.limbs import bytes_to_limbs, bytes_to_words, NBYTES
from .binfile import BinFile, write_binfile

GROTH16_PROTOCOL_ID = 1

COEF_DTYPE = np.dtype([
    ("m", "<u4"), ("c", "<u4"), ("s", "<u4"), ("coef", "<u4", (8,)),
])


@dataclass
class ZKey:
    n8q: int
    q: int
    n8r: int
    r: int
    n_vars: int
    n_public: int
    domain_size: int
    n_coefs: int
    # vk points: (2,16)/(4,16) uint32 Montgomery limbs
    vk_alpha1: np.ndarray
    vk_beta1: np.ndarray
    vk_beta2: np.ndarray
    vk_gamma2: np.ndarray
    vk_delta1: np.ndarray
    vk_delta2: np.ndarray
    # coefficient table
    coef_m: np.ndarray  # (nCoefs,) uint32
    coef_c: np.ndarray
    coef_s: np.ndarray
    coef_val: np.ndarray  # (nCoefs, 8) uint32 WORDS, Montgomery Fr
    # point tables (Montgomery Fq affine), u32-WORD layout — a direct
    # reinterpretation of the on-disk bytes (= the device wire format)
    points_a: np.ndarray  # (nVars, 2, 8)
    points_b1: np.ndarray  # (nVars, 2, 8)
    points_b2: np.ndarray  # (nVars, 4, 8)
    points_c: np.ndarray  # (nVars - nPublic - 1, 2, 8)
    points_h: np.ndarray  # (domainSize, 2, 8)
    ic: Optional[np.ndarray] = None  # (nPublic+1, 2, 8)
    # Underlying mapped file. Kept open for the lifetime of the ZKey, like
    # the reference keeps raw section pointers alive (main_prover.cpp:67-74).
    # Point/coef arrays view the map zero-copy: close() invalidates them,
    # so call it only once the ZKey (or a Prover built from it, which
    # repacks the tables) is done with.
    file: Optional[BinFile] = None

    def close(self) -> None:
        """Unmap the backing file (long-running services re-registering
        circuits would otherwise accumulate maps).

        The point tables view the map zero-copy, so they are dropped
        first: on the pure-Python reader live exports would make
        mmap.close() raise BufferError, and on the native loader they
        would dangle into unmapped memory — invalidating them makes any
        post-close access raise instead of corrupting memory. Snapshot
        what you need (or build a Prover, which repacks the tables)
        before closing."""
        for name in ("points_a", "points_b1", "points_b2", "points_c",
                     "points_h", "ic"):
            setattr(self, name, None)
        if self.file is not None:
            self.file.close()
            self.file = None

    def __enter__(self) -> "ZKey":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_zkey(path: str) -> ZKey:
    from .native import open_binfile
    f = open_binfile(path, "zkey", 1)
    (protocol,) = struct.unpack_from("<I", f.section_bytes(1), 0)
    if protocol != GROTH16_PROTOCOL_ID:
        raise ValueError("zkey file is not groth16")

    h = f.section_bytes(2)
    pos = 0
    (n8q,) = struct.unpack_from("<I", h, pos); pos += 4
    q = int.from_bytes(bytes(h[pos:pos + n8q]), "little"); pos += n8q
    (n8r,) = struct.unpack_from("<I", h, pos); pos += 4
    r = int.from_bytes(bytes(h[pos:pos + n8r]), "little"); pos += n8r
    n_vars, n_public, domain_size = struct.unpack_from("<III", h, pos)
    pos += 12

    def g1():
        nonlocal pos
        v = bytes_to_limbs(bytes(h[pos:pos + 2 * n8q])).reshape(2, 16)
        pos += 2 * n8q
        return v

    def g2():
        nonlocal pos
        v = bytes_to_limbs(bytes(h[pos:pos + 4 * n8q])).reshape(4, 16)
        pos += 4 * n8q
        return v

    vk_alpha1, vk_beta1 = g1(), g1()
    vk_beta2, vk_gamma2 = g2(), g2()
    vk_delta1, vk_delta2 = g1(), g2()

    n_coefs = f.section_size(4) // (12 + n8r)
    coef_raw = np.frombuffer(
        f.section_bytes(4), dtype=COEF_DTYPE, count=n_coefs, offset=4)
    coef_m = np.ascontiguousarray(coef_raw["m"])
    coef_c = np.ascontiguousarray(coef_raw["c"])
    coef_s = np.ascontiguousarray(coef_raw["s"])
    coef_val = np.ascontiguousarray(coef_raw["coef"])  # (n, 8) words

    def points(section: int, count: int, words: int) -> np.ndarray:
        # pure byte reinterpretation: the on-disk 32-byte LE coordinates
        # ARE the packed u32-word layout the device tables use
        return bytes_to_words(f.section_u8(section)).reshape(count, words, 8)

    points_a = points(5, n_vars, 2)
    points_b1 = points(6, n_vars, 2)
    points_b2 = points(7, n_vars, 4)
    points_c = points(8, n_vars - n_public - 1, 2)
    points_h = points(9, domain_size, 2)
    ic = points(3, n_public + 1, 2) if 3 in f.sections else None

    return ZKey(
        n8q=n8q, q=q, n8r=n8r, r=r,
        n_vars=n_vars, n_public=n_public, domain_size=domain_size,
        n_coefs=n_coefs,
        vk_alpha1=vk_alpha1, vk_beta1=vk_beta1, vk_beta2=vk_beta2,
        vk_gamma2=vk_gamma2, vk_delta1=vk_delta1, vk_delta2=vk_delta2,
        coef_m=coef_m, coef_c=coef_c, coef_s=coef_s, coef_val=coef_val,
        points_a=points_a, points_b1=points_b1, points_b2=points_b2,
        points_c=points_c, points_h=points_h, ic=ic, file=f,
    )


# ---------------------------------------------------------------------------
# Writer (fixture generation): plain-int ZKeyData -> snarkjs byte format
# ---------------------------------------------------------------------------

def _mont_bytes_fq(x: int) -> bytes:
    from ..ref.field import FQ_CTX
    return FQ_CTX.to_mont(x).to_bytes(NBYTES, "little")


def _g1_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * (2 * NBYTES)
    return _mont_bytes_fq(pt[0]) + _mont_bytes_fq(pt[1])


def _g2_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * (4 * NBYTES)
    (x0, x1), (y0, y1) = pt
    return (_mont_bytes_fq(x0) + _mont_bytes_fq(x1)
            + _mont_bytes_fq(y0) + _mont_bytes_fq(y1))


def _pts_section(pts, g2: bool):
    """Point-table section payload. Accepts ref plain-int affine points
    (None = infinity) or an (n, k, 8) u32 Montgomery WORD array — the
    latter IS the on-disk layout, written as it is (fixtures.fast_setup
    emits it from device memory; a python-int round trip per point would
    dominate 2^24-scale generation)."""
    if isinstance(pts, np.ndarray):
        return np.ascontiguousarray(pts, dtype="<u4")
    fn = _g2_bytes if g2 else _g1_bytes
    return b"".join(fn(pt) for pt in pts)


def _coef_section(coefs):
    """Section 4: the u32 count, then the records. Accepts (m, c, s,
    Montgomery int) tuples or a COEF_DTYPE record array, written as it
    is."""
    head = struct.pack("<I", len(coefs))
    if isinstance(coefs, np.ndarray):
        return [head, np.ascontiguousarray(coefs, dtype=COEF_DTYPE)]
    return [head] + [struct.pack("<III", m, c, s)
                     + coef_mont.to_bytes(NBYTES, "little")
                     for (m, c, s, coef_mont) in coefs]


def write_zkey(path: str, zkey_data) -> None:
    """Write a ref.groth16.ZKeyData as a .zkey file, section by section
    (no section is joined with another in memory). Points are plain-int
    affine tuples or word arrays, coefficients tuples or a record array
    (_pts_section, _coef_section)."""
    from ..ref.field import P, R_FR

    sec1 = struct.pack("<I", GROTH16_PROTOCOL_ID)

    sec2 = struct.pack("<I", NBYTES) + P.to_bytes(NBYTES, "little")
    sec2 += struct.pack("<I", NBYTES) + R_FR.to_bytes(NBYTES, "little")
    sec2 += struct.pack("<III", zkey_data.n_vars, zkey_data.n_public,
                        zkey_data.domain_size)
    sec2 += _g1_bytes(zkey_data.vk_alpha1) + _g1_bytes(zkey_data.vk_beta1)
    sec2 += _g2_bytes(zkey_data.vk_beta2) + _g2_bytes(zkey_data.vk_gamma2)
    sec2 += _g1_bytes(zkey_data.vk_delta1) + _g2_bytes(zkey_data.vk_delta2)

    sec3 = _pts_section(zkey_data.ic, g2=False)

    sec4 = _coef_section(zkey_data.coefs)

    sec5 = _pts_section(zkey_data.points_a, g2=False)
    sec6 = _pts_section(zkey_data.points_b1, g2=False)
    sec7 = _pts_section(zkey_data.points_b2, g2=True)
    sec8 = _pts_section(zkey_data.points_c, g2=False)
    sec9 = _pts_section(zkey_data.points_h, g2=False)
    sec10 = b""  # contributions: opaque, unused by the prover

    write_binfile(path, "zkey", 1, [
        (1, sec1), (2, sec2), (3, sec3), (4, sec4), (5, sec5),
        (6, sec6), (7, sec7), (8, sec8), (9, sec9), (10, sec10),
    ])


# ---------------------------------------------------------------------------
# Conversion to the pure-Python ref model (tests)
# ---------------------------------------------------------------------------

def zkey_to_ref(zk: ZKey, tables: bool = True):
    """Convert parsed limb arrays to ref.groth16.ZKeyData (plain ints).
    tables=False keeps only what verification reads (the vk points and
    IC): a 2^20 circuit's point tables as Python ints take minutes."""
    from ..ref.field import FQ_CTX, P
    from ..ref.groth16 import ZKeyData
    from ..utils.limbs import limbs_to_ints, words_to_ints

    def _pt(vals, g2: bool) -> Optional[tuple]:
        coords = [FQ_CTX.from_mont(v) for v in vals]
        if all(v == 0 for v in coords):
            return None
        if g2:
            x0, x1, y0, y1 = coords
            return ((x0, x1), (y0, y1))
        return tuple(coords)

    # point tables are (n, k, 8) u32 WORDS; vk header points stay (k, 16)
    # 16-bit limbs (parsed separately from section 2)
    def pt_g1(words):
        return _pt(words_to_ints(words), g2=False)

    def pt_g2(words):
        return _pt(words_to_ints(words), g2=True)

    def vk_g1(limbs):
        return _pt(limbs_to_ints(limbs), g2=False)

    def vk_g2(limbs):
        return _pt(limbs_to_ints(limbs), g2=True)

    if not tables:
        return ZKeyData(
            n_vars=zk.n_vars, n_public=zk.n_public,
            domain_size=zk.domain_size, coefs=[],
            vk_alpha1=vk_g1(zk.vk_alpha1), vk_beta1=vk_g1(zk.vk_beta1),
            vk_beta2=vk_g2(zk.vk_beta2), vk_gamma2=vk_g2(zk.vk_gamma2),
            vk_delta1=vk_g1(zk.vk_delta1), vk_delta2=vk_g2(zk.vk_delta2),
            points_a=[], points_b1=[], points_b2=[], points_c=[],
            points_h=[], ic=[pt_g1(p) for p in zk.ic])
    coefs = [
        (int(m), int(c), int(s), v)
        for m, c, s, v in zip(zk.coef_m, zk.coef_c, zk.coef_s,
                              words_to_ints(zk.coef_val))
    ]
    return ZKeyData(
        n_vars=zk.n_vars, n_public=zk.n_public, domain_size=zk.domain_size,
        coefs=coefs,
        vk_alpha1=vk_g1(zk.vk_alpha1), vk_beta1=vk_g1(zk.vk_beta1),
        vk_beta2=vk_g2(zk.vk_beta2), vk_gamma2=vk_g2(zk.vk_gamma2),
        vk_delta1=vk_g1(zk.vk_delta1), vk_delta2=vk_g2(zk.vk_delta2),
        points_a=[pt_g1(p) for p in zk.points_a],
        points_b1=[pt_g1(p) for p in zk.points_b1],
        points_b2=[pt_g2(p) for p in zk.points_b2],
        points_c=[pt_g1(p) for p in zk.points_c],
        points_h=[pt_g1(p) for p in zk.points_h],
        ic=[pt_g1(p) for p in zk.ic] if zk.ic is not None else [],
    )
