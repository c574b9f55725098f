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

With `mesh` (parallel/multihost.Mesh) the prove runs on every rank of a
multi-process job, as the JAX package's does over its device mesh: each
rank holds its contiguous 1/D slice of the point tables
(multihost.shard_rows) and runs the MSMs on it (parallel/pmsm), the
coefficient tables and the accumulation are replicated, and the coset
transforms are four-step distributed NTTs (parallel/pntt) on the rank's
1/D of the domain, or replicated whole when D does not divide the
four-step's N1 and N2. The MSM's shard (nmax/D points) and the NTT's
(N/D) do not line up, so the rank's h slices are gathered into the whole
h row before each rank cuts its MSM slice of the scalar rows. r and s
are rank 0's. Every rank returns the same proof.

The MSMs' geometry (the slice, c, the window group) is config.msm_plan's
for the rank's axis and the card's memory, or the arguments' or the
environment's; the point axis is padded to whole slices, so the scan's
working set is a slice's, whatever the wire count. The front
runs on packed words from end to end, so its working set is its outputs
and the resident tables whatever the slots per row (K). An H100's 80 GB
hold the tables, the front and the MSMs of a 2^24 prove (`prove(peaks=)`
measures each stage; PERF.md has the peaks at K = 1 and K = 3), so none
of the JAX package's memory workarounds (blocked G1 tables, stage
paging, layout pinning, the chunked front) is carried over.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import config, device as D
from .io.zkey import ZKey
from .ops import front as FRONT
from .ops import msm as MSM
from .ops.curve import G1P, G2P
from .ops.ntt import NTTPlan, powers_mont, to_odd_coset
from .parallel import multihost as MH, pmsm as PM
from .parallel.pntt import DNTTPlan, dntt
from .ref.field import FQ_CTX, R_FR, fr_w
from .ref.groth16 import Proof, sample_rs
from .utils import staging as STAGE
from .utils.hostcurve import G1H, G2H
from .utils.logger import TRACE, collect, get_logger, phase


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
                 segment: Optional[int] = None, device=None,
                 mesh: Optional[MH.Mesh] = None):
        """The arguments win over the environment knobs (config.py).
        With `mesh` the Prover is this rank's part of a sharded prove on
        the mesh's device (`device`, when given, must be that one)."""
        self.mesh = mesh
        if mesh is not None:
            if device is not None and \
                    torch.device(device) != torch.device(mesh.device):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
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
        npts = max(self.domain, self.n_vars)
        # the plan for the rank's axis (config.msm_plan), each of its
        # choices overridden by the argument, then the environment; the
        # axis (with a mesh, every rank's slice of it) is padded to whole
        # segments with (0, 0) points and zero scalars, so a circuit with
        # more wires than its domain is sliced too (the JAX package scans
        # its whole axis there); a segment that is not a multiple of the
        # scan chunk falls back to the whole-axis scan
        ranks = 1 if mesh is None else mesh.size
        self.plan = config.msm_plan(
            PM.pad_len_sharded(npts, ranks) // ranks, 4,  # four G1 rows
            1 if mesh is None else MH.ranks_on_device(mesh),
            D.total_memory(dev))
        seg = next(v for v in (segment, config.int_env("RSTPU_MSM_SEGMENT"),
                               self.plan.segment) if v is not None)
        self.segment = seg if seg % MSM._CHUNK == 0 else 0
        self.nmax = PM.pad_len_sharded(npts, ranks, self.segment)
        self.c_bits = window_bits or config.window_bits() or self.plan.c
        self.window_group = (window_group
                             or config.int_env("RSTPU_WINDOW_GROUP")
                             or self.plan.G)
        self.ntt_seq = config.ntt_sequential(self.power)

        # point tables: packed affine (rows, nmax, A, 8), the zkey layout;
        # with a mesh the rank's nmax/D rows of each. table_stage is the
        # host's part (padding, stacking, int32 copies: where the pages of
        # a mapped zkey are read), table_copy the host-to-card copies
        g1_tables = (zkey.points_h, zkey.points_a, zkey.points_b1,
                     zkey.points_c)
        with self._setup_phase("table_stage"):
            if mesh is None:
                g1 = _i32(np.stack([_pad_points(t, self.nmax)
                                    for t in g1_tables]))
            else:
                g1 = torch.stack([MH.shard_rows(t, mesh, 0, self.nmax)
                                  for t in g1_tables])
        with self._setup_phase("table_copy"):
            self.pts_g1 = g1.to(dev)                        # (4, nmax, 2, 8)
        del g1
        with self._setup_phase("table_stage"):
            b2 = (_i32(_pad_points(zkey.points_b2, self.nmax)[None])
                  if mesh is None else
                  MH.shard_rows(zkey.points_b2, mesh, 0, self.nmax)[None])
        with self._setup_phase("table_copy"):
            b2 = b2.to(dev)                                 # (1, nmax, 4, 8)
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
            self._ntt_tables()
        self.last_phases: Dict[str, float] = {}
        self.last_trace: Optional[str] = None
        self._traces = 0
        self._staging: Optional[STAGE.Ring] = None
        self.released = False

    def _ntt_tables(self) -> None:
        """The coset transforms' tables: with a mesh whose size divides
        the four-step's N1 and N2, the distributed plan and the rank's
        slice of the coset powers eta^k; else the whole-domain plan
        (replicated on every rank of a mesh)."""
        self.dntt_plan, self.dntt_arrays = None, {}
        if self.mesh is not None:
            try:
                self.dntt_plan = DNTTPlan(self.power, self.mesh.size,
                                          self.device)
            except ValueError:
                pass                    # tiny domain: the replicated NTT
        if self.dntt_plan is None:
            self.ntt_arrays = NTTPlan(
                self.power, self.device,
                keep=("fwd_tw", "inv_tw", "coset_ninv_br")).tensors()
            return
        self.dntt_arrays = self.dntt_plan.tensors()
        nloc = self.domain // self.mesh.size
        eta = fr_w(self.power + 1)
        self.ntt_arrays = {"coset": powers_mont(
            eta, nloc, pow(eta, self.mesh.rank * nloc, R_FR),
            device=self.device)}

    @contextlib.contextmanager
    def _setup_phase(self, name: str):
        """Time one part of the set-up, its card work included, into
        setup_phases and the trace log (a part timed in pieces adds them
        up)."""
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
        get_logger().log(TRACE, "coef_binning: K = %d slots a row, %d of "
                         "%d records spilled", K, left.numel(), ncoefs)
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
        if self.dntt_plan is not None:
            out["dntt"] = self.dntt_arrays
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
        (3, nmax, 8) [h, wit, c] of plain little-endian packed scalars;
        with a mesh the rank's (3, nmax/D, 8) slice of it."""
        ab, cvec = self._acc(witness, tables)
        polys = self._cosets(ab, cvec, tables)
        del ab, cvec          # each stage's inputs die before the next
        hp = self._h_poly(*polys)
        del polys
        if self.dntt_plan is not None:
            hp = self.mesh.all_gather(hp).reshape(self.domain, 8)
        return self._rows(witness, hp)

    def _acc(self, witness, tables):
        """Coefficient accumulation + pointwise product -> (ab (2, N, 8),
        cvec (N, 8)) canonical evaluations, packed."""
        n = self.domain
        spill = None
        if "left_s" in tables:
            spill = FRONT.Spill(*(tables[k] for k in FRONT.SPILL_TABLES))
        with phase("front.acc", device=self.device):
            ab = FRONT.fr_slot_acc(witness, tables["coef_s"],
                                   tables["coef_val"], spill).reshape(2, n, 8)
        return ab, FRONT.fr_pointwise("mul", ab[0], ab[1])

    def _cosets(self, ab, cvec, tables):
        """Evaluations -> odd-coset evaluations (a2, b2, c2). With
        config.ntt_sequential a, b, c go through one at a time, never
        stacked, so the transform's temporaries are one polynomial's.
        With the distributed plan: the rank's 1/D slice of each, through
        the four-step transforms (ntt_sequential does not apply, as in
        the JAX package)."""
        if self.dntt_plan is not None:
            nloc = self.domain // self.mesh.size
            lo = self.mesh.rank * nloc
            polys = torch.stack([ab[0, lo:lo + nloc], ab[1, lo:lo + nloc],
                                 cvec[lo:lo + nloc]])
            polys = dntt(polys, tables["dntt"], self.dntt_plan, self.mesh,
                         inverse=True)
            polys = FRONT.fr_pointwise("mul", polys, tables["ntt"]["coset"])
            polys = dntt(polys, tables["dntt"], self.dntt_plan, self.mesh)
            return polys[0], polys[1], polys[2]
        if self.ntt_seq:
            return tuple(to_odd_coset(v, tables["ntt"])
                         for v in (ab[0], ab[1], cvec))
        polys = to_odd_coset(torch.cat([ab, cvec[None]]), tables["ntt"])
        return polys[0], polys[1], polys[2]

    def _h_poly(self, a2, b2, c2):
        """h = fromMontgomery(a2*b2 - c2) (groth16.cpp:162), packed."""
        return FRONT.fr_pointwise("h", a2, b2, c2)

    def _rows(self, witness, hp):
        """The scalar rows [h, wit, c] of the MSMs, zero past each
        vector's end; with a mesh the rank's nmax/D columns of them."""
        per = self.nmax if self.mesh is None else self.nmax // self.mesh.size
        lo = 0 if self.mesh is None else self.mesh.rank * per
        rows = torch.zeros((3, per, 8), dtype=torch.int32,
                           device=witness.device)
        for i, src in enumerate((hp, witness, witness[self.n_public + 1:])):
            hi = min(lo + per, src.shape[0])
            if hi > lo:
                rows[i, :hi - lo] = src[lo:hi]
        return rows

    def msms(self, rows, tables, peaks=None):
        """The five MSMs -> window totals (W, 4, 3, 8) and (W, 1, 6, 8);
        with a mesh each rank's over its shard, summed over the ranks."""
        h_row, wit_row, c_row = rows[0], rows[1], rows[2]
        with self._peak("msm_g1", peaks):
            g1_sc = torch.stack([h_row, wit_row, wit_row, c_row])
            g1w = self._msm(G1P, tables["pts_g1"], g1_sc)
            del g1_sc
        with self._peak("msm_g2", peaks):
            g2w = self._msm(G2P, tables["pts_g2"], wit_row[None])
        return g1w, g2w

    def _msm(self, curve, pts, scalars):
        if self.mesh is None:
            return MSM.msm(curve, pts, scalars, self.c_bits,
                           self.window_group, segment=self.segment)
        return PM.msm_sharded(curve, pts, scalars, self.c_bits, self.mesh,
                              self.window_group, combine=False,
                              segment=self.segment)

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
        """Drop every device table and give the witness's pinned staging
        buffers back; the instance cannot prove afterwards."""
        self.pts_g1 = self.pts_g2 = None
        self.coef_s = self.coef_val = None
        self.spill = self.left_order = self.left_seg = self.acc2_seg = None
        self.ntt_arrays, self.dntt_arrays = {}, {}
        if self._staging is not None:
            self._staging.release()
            self._staging = None
        self.released = True

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prove(self, witness_words: np.ndarray, r: Optional[int] = None,
              s: Optional[int] = None,
              peaks: Optional[dict] = None) -> Tuple[Proof, list]:
        """witness_words: (nVars, 8) uint32 standard-form values (the wtns
        section-2 payload). Returns (Proof, public signal ints); fills
        last_phases with front / msms / host / total seconds (with a mesh
        also each collective's seconds and calls), and `peaks` (when
        given, on the card) with the device peak of the front and of each
        MSM stage in bytes. With a mesh, r and s are rank 0's. With
        RSTPU_PROFILE set, a torch.profiler trace of the prove is written
        into that directory (last_trace names the file). While spans are
        on (a profiler records, or RSTPU_LOG_LEVEL=trace; utils/logger)
        last_phases also holds the spans inside front and msms, seconds
        of the card on a card: front.upload (the witness's copy, on a
        card through pinned staging chunks), front.acc (fr_slot_acc: the
        slots and any spill) and msms.prep / sort / gather / scan /
        buckets, each summed over the MSMs' slices and window groups;
        each is also a profiler range "rstpu.<key>". It then also holds
        two counts over the MSMs' window groups: count.msms.entries, the
        (point, window) entries sorted and scanned, and count.msms.live,
        those of a nonzero digit; and on a card count.front.staged, the
        witness's chunks staged (utils/staging.chunk_plan)."""
        if r is None:
            r = sample_rs()
        if s is None:
            s = sample_rs()
        stats0 = None
        if self.mesh is not None:
            stats0 = dict(self.mesh.stats)
            r, s = self._rank0_rs(r, s)
        prof_dir = config.profile_dir()
        with (self._profiled(prof_dir) if prof_dir
              else contextlib.nullcontext()):
            out = self._prove(witness_words, r, s, peaks)
        if stats0 is not None:
            for k, v in self.mesh.stats.items():
                self.last_phases[k] = v - stats0.get(k, 0)
        return out

    def _rank0_rs(self, r: int, s: int) -> Tuple[int, int]:
        """Rank 0's (r, s) on every rank: the blinding enters only the
        host assembly, so every rank must assemble with the same."""
        words = np.frombuffer(r.to_bytes(32, "little")
                              + s.to_bytes(32, "little"), "<u4").copy()
        got = self.mesh.broadcast(_i32(words)).cpu().numpy().view(np.uint32)
        buf = got.tobytes()
        return (int.from_bytes(buf[:32], "little"),
                int.from_bytes(buf[32:], "little"))

    @contextlib.contextmanager
    def _profiled(self, out_dir: str):
        """A torch.profiler trace (CPU, and the card's kernels on a card)
        of the block (device.traced: on a card its spin kernels lead the
        block's), exported as a Chrome trace into out_dir."""
        os.makedirs(out_dir, exist_ok=True)
        self._traces += 1
        rank = 0 if self.mesh is None else self.mesh.rank
        path = os.path.join(
            out_dir, f"prove_{os.getpid()}_rank{rank}_{self._traces}.json")
        with D.traced(self.device, lambda prof: prof.export_chrome_trace(
                path)):
            yield
        self.last_trace = path

    def _upload(self, wit: np.ndarray) -> torch.Tensor:
        """The witness words as an int32 (n_vars, 8) tensor on the device:
        on a card through the Prover's ring of pinned staging buffers
        (utils/staging), taken at the first prove and held until
        release()."""
        if self.device.type != "cuda":
            witness = _i32(wit)
            with phase("front.upload", device=self.device):
                return witness.to(self.device)
        if self._staging is None:
            self._staging = STAGE.Ring()
        with phase("front.upload", device=self.device):
            return self._staging.upload(wit, self.device)

    def _prove(self, witness_words, r: int, s: int, peaks):
        rs = r * s % R_FR
        t0 = time.perf_counter()
        wit = np.asarray(witness_words, dtype=np.uint32)
        if wit.shape != (self.n_vars, 8):
            raise ValueError(f"witness has shape {wit.shape}, expected "
                             f"({self.n_vars}, 8)")
        self.last_phases = {}
        tables = self.tables()
        with collect(self.last_phases) as spans:
            with phase("front", self.last_phases), \
                    self._peak("front", peaks):
                witness = self._upload(wit)
                rows = self.front(witness, tables)
                self._sync()
            with phase("msms", self.last_phases):
                g1w, g2w = self.msms(rows, tables, peaks)
                g1w = g1w.cpu().numpy().view(np.uint32)
                g2w = g2w.cpu().numpy().view(np.uint32)
            spans.read_card()        # the copies to the host synchronised

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
