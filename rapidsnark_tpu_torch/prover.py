"""Groth16 prover for one device on torch tensors.

Counterpart of `rapidsnark_tpu/prover.py` on its single-device path:
  coefficient accumulation (groth16.cpp:52-96)  slots binned at set-up
                                                (rows denser than K spill
                                                to a row-sorted list),
                                                summed by
                                                ops/front.fr_slot_acc
  coset FFTs (groth16.cpp:99-155)               ops/ntt.to_odd_coset
  h = a*b - c (groth16.cpp:157-166)             ops/front.fr_pointwise
  five MSMs (groth16.cpp:173-204)               ops/msm.msm, the four G1
                                                MSMs on one row axis, G2
                                                on the iso-twist
  combine + assembly (groth16.cpp:209-246)      exact host int math
Given the same (r, s) the proof is byte-identical to the reference's.

Past 2^21 points the MSMs run segmented (config.msm_segment, or the
`segment` argument): the scan's working set is then a slice's. The front
runs on packed words from end to end, so its working set is its outputs
and the resident tables whatever the slots per row (K). An H100's 80 GB
hold the tables, the front and the MSMs of a 2^24 prove (`prove(peaks=)`
measures each stage; PERF.md has the peaks at K = 1 and K = 3), so none
of the JAX package's memory workarounds (blocked G1 tables, stage
paging, layout pinning, the chunked front) is carried over.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import config, device as D
from .io.zkey import ZKey
from .ops import front as FRONT
from .ops import msm as MSM
from .ops.curve import G1P, G2P
from .ops.ntt import NTTPlan, to_odd_coset
from .ref.field import FQ_CTX, R_FR
from .ref.groth16 import Proof, sample_rs
from .utils.hostcurve import G1H, G2H
from .utils.logger import phase


def _log2(n: int) -> int:
    p = n.bit_length() - 1
    if n < 1 or 1 << p != n:
        raise ValueError("domainSize must be a power of two")
    return p


def _pad_points(pts: np.ndarray, npad: int) -> np.ndarray:
    n = pts.shape[0]
    if n == npad:
        return pts
    return np.concatenate(
        [pts, np.zeros((npad - n,) + pts.shape[1:], np.uint32)], axis=0)


def _i32(a: np.ndarray) -> torch.Tensor:
    """u32 word array -> int32 tensor of the same bits (CPU)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int32))


def _words_int(row) -> int:
    return sum((int(v) & 0xFFFFFFFF) << (32 * i)
               for i, v in enumerate(np.asarray(row)))


def _coord(words) -> int:
    """Packed Montgomery words (any representative) -> plain int mod p."""
    return FQ_CTX.from_mont(_words_int(words))


def host_g1(words) -> tuple:
    """Packed projective G1 words (3, 8) -> host point (x, y, z) ints."""
    return tuple(_coord(words[k]) for k in range(3))


def host_g2(words) -> tuple:
    """Packed projective G2 words (6, 8) -> host point of Fq2 pairs."""
    return tuple((_coord(words[2 * k]), _coord(words[2 * k + 1]))
                 for k in range(3))


def _ref_g1(limbs):
    from .utils.limbs import limbs_to_ints
    xi, yi = (FQ_CTX.from_mont(v) for v in limbs_to_ints(limbs))
    return None if xi == 0 and yi == 0 else (xi, yi)


def _ref_g2(limbs):
    from .utils.limbs import limbs_to_ints
    x0, x1, y0, y1 = (FQ_CTX.from_mont(v) for v in limbs_to_ints(limbs))
    if x0 == x1 == y0 == y1 == 0:
        return None
    return ((x0, x1), (y0, y1))


class Prover:
    """One circuit's proving context: device-resident zkey tables, NTT
    tables and the binned coefficient slots."""

    def __init__(self, zkey: ZKey, window_bits: Optional[int] = None,
                 window_group: Optional[int] = None,
                 segment: Optional[int] = None, device=None):
        """The arguments win over the environment knobs (config.py)."""
        self.device = D.resolve(device)
        dev = self.device
        self.setup_phases: Dict[str, float] = {}
        self.n_vars = zkey.n_vars
        self.n_public = zkey.n_public
        self.domain = zkey.domain_size
        self.power = _log2(self.domain)
        self.n_c = zkey.points_c.shape[0]
        if zkey.r != R_FR:
            raise ValueError("zkey curve is not bn128")
        self.nmax = MSM.pad_len(max(self.domain, self.n_vars))
        self.segment = (segment if segment is not None
                        else config.msm_segment(self.nmax))
        if self.segment and self.nmax % self.segment:
            self.segment = 0  # odd sizes: fall back to the whole-axis scan
        self.c_bits = (window_bits or config.window_bits()
                       or MSM.best_window_bits(self.nmax, self.segment))
        self.window_group = window_group or config.window_group()
        self.ntt_seq = config.ntt_sequential(self.power)

        # point tables: packed affine (rows, nmax, A, 8), the zkey layout
        with self._setup_phase("table_upload"):
            g1 = np.stack([_pad_points(zkey.points_h, self.nmax),
                           _pad_points(zkey.points_a, self.nmax),
                           _pad_points(zkey.points_b1, self.nmax),
                           _pad_points(zkey.points_c, self.nmax)])
            self.pts_g1 = _i32(g1).to(dev)                  # (4, nmax, 2, 8)
            del g1
            b2 = _pad_points(zkey.points_b2, self.nmax)[None]
            b2 = _i32(b2).to(dev)                           # (1, nmax, 4, 8)
        with self._setup_phase("g2_rescale"):
            self.pts_g2 = MSM.g2_rescale_packed(b2)
            del b2

        self.ref_vk = {
            "alpha1": _ref_g1(zkey.vk_alpha1),
            "beta1": _ref_g1(zkey.vk_beta1),
            "delta1": _ref_g1(zkey.vk_delta1),
            "beta2": _ref_g2(zkey.vk_beta2),
            "delta2": _ref_g2(zkey.vk_delta2),
        }

        with self._setup_phase("coef_binning"):
            self._bin_coefficients(zkey)
        with self._setup_phase("ntt_plan"):
            self.ntt_arrays = NTTPlan(
                self.power, dev,
                keep=("fwd_tw", "inv_tw", "coset_ninv_br")).tensors()
        self.last_phases: Dict[str, float] = {}
        self.released = False

    @contextlib.contextmanager
    def _setup_phase(self, name: str):
        """Time one part of the set-up, its card work included, into
        setup_phases and the trace log."""
        with phase(name, self.setup_phases):
            yield
            self._sync()

    def _bin_coefficients(self, zkey: ZKey) -> None:
        """Bin the coefficient records by target row (a|b, constraint)
        into K slots per row (slot-major, ops/front.slot_tables), on the
        device; the records past a row's K slots are kept sorted by row
        with their work list (ops/front.make_spill). For ops/convert the
        spilled records' permutation (left_order) and their segment
        tables in the JAX package's layout (left_seg, two-level acc2_seg
        past 2^15 terms a row) are kept too; the front reads neither."""
        dev = self.device
        n = self.domain
        if self.n_vars >= 1 << 31:
            raise ValueError("more than 2^31 wires: witness indices are "
                             "int32")
        seg = (torch.from_numpy(zkey.coef_m.astype(np.int64)) * n
               + torch.from_numpy(zkey.coef_c.astype(np.int64))).to(dev)
        ncoefs = seg.shape[0]
        coef_s = torch.from_numpy(zkey.coef_s.astype(np.int32)).to(dev)
        coef_val = _i32(zkey.coef_val).to(dev)
        counts = torch.bincount(seg, minlength=2 * n)
        K = 1
        while K < 16 and \
                int((counts - K).clamp(min=0).sum()) > 0.05 * ncoefs:
            K += 1
        self.coef_slots = K
        self.coef_s, self.coef_val, left, lrank = FRONT.slot_tables(
            coef_s, coef_val, seg, 2 * n, K)
        cap = 1 << 15
        self.spill = self.left_order = self.left_seg = self.acc2_seg = None
        if left.numel():
            lseg = seg[left]
            self.spill, self.left_order = FRONT.make_spill(
                coef_s[left], coef_val[left], lseg, 2 * n)
            if int(counts.max()) - K < cap:
                self.left_seg = lseg
            else:
                nsub = (int(counts.max()) - K - 1) // cap + 1
                if nsub >= cap:
                    raise ValueError("coefficient section too dense "
                                     "(> 2^30 terms on one row)")
                uniq, inv = torch.unique(lseg * nsub + (lrank >> 15),
                                         return_inverse=True)
                self.left_seg = inv
                self.acc2_seg = uniq // nsub

    @property
    def left_s(self):
        """The spilled records' witness indices, sorted by row (None when
        every record has a slot)."""
        return None if self.spill is None else self.spill.s

    def tables(self) -> dict:
        if self.released:
            raise RuntimeError(
                "Prover.release() was called; construct a new Prover")
        out = {"pts_g1": self.pts_g1, "pts_g2": self.pts_g2,
               "coef_s": self.coef_s, "coef_val": self.coef_val,
               "ntt": self.ntt_arrays}
        if self.spill is not None:
            out.update(zip(FRONT.SPILL_TABLES, self.spill))
            out["left_order"] = self.left_order
            out["left_seg"] = self.left_seg
        if self.acc2_seg is not None:
            out["acc2_seg"] = self.acc2_seg
        return out

    # -- front: witness -> MSM scalar rows -----------------------------------
    def front(self, witness, tables):
        """witness (nVars, 8) int32 standard-form words -> the rows stack
        (3, nmax, 8) [h, wit, c] of plain little-endian packed scalars."""
        ab, cvec = self._acc(witness, tables)
        polys = self._cosets(ab, cvec, tables)
        del ab, cvec          # each stage's inputs die before the next
        hp = self._h_poly(*polys)
        del polys
        return self._rows(witness, hp)

    def _acc(self, witness, tables):
        """Coefficient accumulation + pointwise product -> (ab (2, N, 8),
        cvec (N, 8)) canonical evaluations, packed."""
        n = self.domain
        spill = None
        if "left_s" in tables:
            spill = FRONT.Spill(*(tables[k] for k in FRONT.SPILL_TABLES))
        ab = FRONT.fr_slot_acc(witness, tables["coef_s"], tables["coef_val"],
                               spill).reshape(2, n, 8)
        return ab, FRONT.fr_pointwise("mul", ab[0], ab[1])

    def _cosets(self, ab, cvec, tables):
        """Evaluations -> odd-coset evaluations (a2, b2, c2). With
        config.ntt_sequential a, b, c go through one at a time, never
        stacked, so the transform's temporaries are one polynomial's."""
        if self.ntt_seq:
            return tuple(to_odd_coset(v, tables["ntt"])
                         for v in (ab[0], ab[1], cvec))
        polys = to_odd_coset(torch.cat([ab, cvec[None]]), tables["ntt"])
        return polys[0], polys[1], polys[2]

    def _h_poly(self, a2, b2, c2):
        """h = fromMontgomery(a2*b2 - c2) (groth16.cpp:162), packed."""
        return FRONT.fr_pointwise("h", a2, b2, c2)

    def _rows(self, witness, hp):
        rows = torch.zeros((3, self.nmax, 8), dtype=torch.int32,
                           device=witness.device)
        rows[0, :self.domain] = hp
        rows[1, :self.n_vars] = witness
        rows[2, :self.n_c] = witness[self.n_public + 1:]
        return rows

    def msms(self, rows, tables, peaks=None):
        """The five MSMs -> window totals (W, 4, 3, 8) and (W, 1, 6, 8)."""
        h_row, wit_row, c_row = rows[0], rows[1], rows[2]
        with self._peak("msm_g1", peaks):
            g1_sc = torch.stack([h_row, wit_row, wit_row, c_row])
            g1w = MSM.msm(G1P, tables["pts_g1"], g1_sc, self.c_bits,
                          self.window_group, segment=self.segment)
            del g1_sc
        with self._peak("msm_g2", peaks):
            g2w = MSM.msm(G2P, tables["pts_g2"], wit_row[None], self.c_bits,
                          self.window_group, segment=self.segment)
        return g1w, g2w

    @contextlib.contextmanager
    def _peak(self, name: str, peaks):
        """peaks[name] = the card's peak of allocated bytes while the
        block runs (the resident tables included); nothing when peaks is
        None or on the CPU. Resets the allocator's peak counter."""
        if peaks is None or self.device.type != "cuda":
            yield
            return
        self._sync()
        torch.cuda.reset_peak_memory_stats(self.device)
        yield
        self._sync()
        peaks[name] = torch.cuda.max_memory_allocated(self.device)

    def release(self) -> None:
        """Drop every device table; the instance cannot prove afterwards."""
        self.pts_g1 = self.pts_g2 = None
        self.coef_s = self.coef_val = None
        self.spill = self.left_order = self.left_seg = self.acc2_seg = None
        self.ntt_arrays = {}
        self.released = True

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prove(self, witness_words: np.ndarray, r: Optional[int] = None,
              s: Optional[int] = None,
              peaks: Optional[dict] = None) -> Tuple[Proof, list]:
        """witness_words: (nVars, 8) uint32 standard-form values (the wtns
        section-2 payload). Returns (Proof, public signal ints); fills
        last_phases with front / msms / host / total seconds, and `peaks`
        (when given, on the card) with the device peak of the front and
        of each MSM stage in bytes."""
        if r is None:
            r = sample_rs()
        if s is None:
            s = sample_rs()
        rs = r * s % R_FR
        t0 = time.perf_counter()
        wit = np.asarray(witness_words, dtype=np.uint32)
        if wit.shape != (self.n_vars, 8):
            raise ValueError(f"witness has shape {wit.shape}, expected "
                             f"({self.n_vars}, 8)")
        self.last_phases = {}
        tables = self.tables()
        with phase("front", self.last_phases), self._peak("front", peaks):
            witness = _i32(wit).to(self.device)
            rows = self.front(witness, tables)
            self._sync()
        with phase("msms", self.last_phases):
            g1w, g2w = self.msms(rows, tables, peaks)
            g1w = g1w.cpu().numpy().view(np.uint32)
            g2w = g2w.cpu().numpy().view(np.uint32)

        t1 = time.perf_counter()
        nwin = g1w.shape[0]

        pih, pi_a, pib1, pi_c = (
            G1H.combine_windows([host_g1(g1w[w, b]) for w in range(nwin)],
                                self.c_bits) for b in range(4))
        pi_b = G2H.combine_windows([host_g2(g2w[w, 0]) for w in range(nwin)],
                                   self.c_bits)
        vk = {k: (G2H if k.endswith("2") else G1H).from_affine(v)
              for k, v in self.ref_vk.items()}
        pi_a = G1H.add(pi_a, vk["alpha1"])
        pi_a = G1H.add(pi_a, G1H.mul(vk["delta1"], r))
        pi_b = G2H.add(pi_b, vk["beta2"])
        pi_b = G2H.add(pi_b, G2H.mul(vk["delta2"], s))
        pib1 = G1H.add(pib1, vk["beta1"])
        pib1 = G1H.add(pib1, G1H.mul(vk["delta1"], s))
        pi_c = G1H.add(pi_c, pih)
        pi_c = G1H.add(pi_c, G1H.mul(pi_a, s))
        pi_c = G1H.add(pi_c, G1H.mul(pib1, r))
        pi_c = G1H.add(pi_c, G1H.neg(G1H.mul(vk["delta1"], rs)))
        self.last_phases["host"] = time.perf_counter() - t1
        self.last_phases["total"] = time.perf_counter() - t0
        proof = Proof(a=G1H.to_affine(pi_a), b=G2H.to_affine(pi_b),
                      c=G1H.to_affine(pi_c))
        publics = [_words_int(wit[i]) for i in range(1, self.n_public + 1)]
        return proof, publics
