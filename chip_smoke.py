#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (rapidsnark_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (sm_90a: H100) and nvcc; exits non-zero without
them, or when run away from the repository. (`chip_smoke.py --rank ...`
is one rank of the sharded phases, which start it themselves.) Phases,
in order; any failure exits non-zero:
  1. the card's name and power limit, torch / CUDA versions, and the
     build of the six kernel libraries (all nvcc processes started
     together) with each kernel's registers, stack frame and spills,
     `nvcc --version`, and per curve kernel the SASS counts of IMAD*,
     IADD3* and all instructions per Montgomery product (cuobjdump;
     skipped with a line where it is missing); fq_scale's registers and
     spills on a line of their own;
  2. each of the fifteen kernels against its plain PyTorch version on the
     same inputs on the card (exact words; G1 outputs of the relaxed law
     compared mod p; ntt_tail also against ntt_fused_pass on bits 0-6),
     and each timed beside the plain version and the least time the card
     could take (bound) two ways: through its Python wrapper (CUDA events
     around back-to-back calls, the host's work included: what a caller
     waits for) and on the device (the same calls captured in one CUDA
     graph, a replay timed with events; torch.profiler's kernel
     durations where a call cannot be captured; each case names its
     method), the share of the bound from the device time; at every
     shape the paths below give it. The MSM geometry of each prove
     (2^20-2^24, the wide 2^22 circuit, a rank of 2^22 over D = 2 and 4
     sharing the card) is config.msm_plan's for its axis and this card's
     memory; the run prints each and a prove fails unless it ran its
     own: a slice's scans, every width `add` is launched at with its
     launches per slice (a whole axis is one slice), every fused pass
     over 3 x 2^21 and 3 x 2^22 and over 1 x 2^23 and 1 x 2^24: top
     passes of 1, 2, 3 and 4 bits), the front and preparation kernels at
     2^21 and 2^23 too, and for dma_gather the tool's default rows and
     the 2^20 prove's G1 and G2 rows, with a permutation and with
     repeated rows, beside torch.index_select (library_ms, device ms as
     the kernel's; its wrapper ms too); the front kernels at the
     2^20, 2^22 and 2^24 proves' shapes (fr_slot_acc with K = 1 and 3
     slots a row and random witness indices, and at 2^20 with a spilled
     row of 100 and one of 2^15 + 700 terms; fr_pointwise's products,
     h, a row broadcast over the per-stage stack and sqchain64's, and
     the 2^24 split's scalar product and difference), at 2^24 held
     against the plain version on a leading slice of the same inputs
     (2^21 rows, 2^22 elements: at full width it needs ~55 GB; a spilled
     row's records in parts of 2^21, summed mod r), and the fixture
     generator's shape (3 x 2^24 rows of one slot and one spilled row of
     2^24 terms); the sharded proves' shapes (the four-step NTT's
     sub-transforms, 3 x c2 polynomials of N1 points, c2 = N2 / D, for
     2^22 over D = 2 and 4 and 2^24 over one rank, both directions, DIT
     with and without the pre-multiply, the plain version on 256 of
     them; the rank's row products 3 x N/D by N/D; `add` at the
     cross-rank sums' widths); the
     small transforms (3 x 128, 2^10 and 2^11 points: the default
     dispatch's fused passes, DIF and DIT with the coset pre-multiply)
     against the per-layer plain version and timed beside the per-layer
     kernels (RSTPU_NTT_FUSE=0), and a (3, 128) to_odd_coset and a
     128-point inverse ntt through the port's functions both ways; the
     MSM's preparation kernels at each geometry's shapes (glv_digits on
     a whole GLV axis or on a slice, every window, an edge table of
     scalars in front and alone at c = 4, 8, 11, 13, 16 with and without
     GLV; fq_scale's phi on a whole table or a slice, a window group's
     bucket negation, the G2 totals' map back off the iso-twist, the G2
     table's rescale at each prove's points: tools/bench_fq_scale's
     cases; and, checked only, a slice
     ending in a ragged block, specs mixing copies, negations and
     products, 70,000 rows of one point, the negations on edge words);
     the MSM's bucket ordering at every window group's shape of every
     geometry above and of the committed sqchain64 and multiplier
     (digit_sort's sorted keys, permutation, sign columns and bucket
     boundaries; gather_cols's columns; _ps_at's two dma_gather
     lookups), beside torch.sort + searchsorted, the advanced-index
     gather and index_select + the move (library_ms), digit_sort's
     launches a call counted on the card from one profiled call (the
     counting pass, its scan, a scatter a radix pass and the tail; any
     other count fails) and, on a log line of its own, its design's own
     traffic (sort_plan) beside its bound, and digit_sort on
     edge tables at c = 4, 8, 9, 13, 16 (all keys 0, keys 0 and 1, every
     key 2^(c+1) - 1, one row of 256, descending keys, one key value a
     tile); every prove below must call digit_sort and gather_cols once
     per window group of each MSM call and dma_gather twice, each launch
     counted, at shapes held here; prefix_totals at each geometry's
     window group (4G rows on G1, G on G2, of width / 256 chunk totals,
     64 multiples of the generator) against its plain version as points,
     its bound the complete adds of a sequential prefix, and every prove
     must call it once a window group of each MSM call (two launches).
     `add`
     is timed
     alone (its C entry point back to back: a narrow launch takes less
     time than the wrapper's Python) and through its wrapper; each scan,
     add and strict mixed add shape prints its launch geometry (threads
     and blocks, resident blocks per SM from the occupancy API, waves);
  3. prove the committed tests/fixtures/sqchain64 through the CLI entry
     point and pairing-verify (the small circuit's NTTs are one fused
     pass a direction, and no ntt_butterfly runs), and time its front
     both ways (fused, RSTPU_NTT_FUSE=0); then the multiplier with one
     record split into 100
     parts and into 2^15 + 700 (spilled rows) on a Prover on the card,
     each proof byte-equal to ref/groth16.prove for a fixed (r, s) and
     pairing-verified. From here on, plain FieldOps arithmetic and limb
     (un)packing on a CUDA tensor raise while Prover.front or the fixture
     generator's evaluation sums (fixtures._evaluations) run, and every
     prove, request and generator run must launch fr_slot_acc and
     fr_pointwise;
  4. generate bench_fixtures/sqchain1048576.{zkey,wtns} on the card and
     prove it through the CLI entry point (cold), then once more on the
     loaded Prover (warm); the proof must pairing-verify, add /
     scan_cols_packed / ntt_fused_pass must each have launched during
     the first prove, at the add widths phase 2 timed. On the loaded
     Prover: the window totals through
     the device combine (ops/msm._combine_windows) against the host
     combine; msm(glv=False) against msm(glv=True) on 2^16 points of the
     same tables; and RSTPU_NTT_SEQ=1 (a, b, c transformed one at a
     time), whose front must give the stacked rows word for word;
  5. the per-stage NTT configuration (RSTPU_NTT_FUSE=0) on the same
     2^20 fixture through the CLI entry point: the proof pairing-
     verifies, ntt_tail and ntt_butterfly both launched, and
     Prover.front gives the fused configuration's rows word for word;
  6. the gather tools in-process at 2^21 rows of 64 bytes (the 2^20
     prove's GLV axis): both must report correct and dma_gather must
     have launched; then the MSM tools (bench_msm_phases, msm_ablate,
     sweep_msm) at the 2^24 and the 2^22 proves' slice widths, each
     stage's ms printed;
  7. the proof server (server.__main__.main on a thread of this
     process) with the 2^20 fixture and sqchain64 as its registry and
     two witness-generator executables written into ./build: over HTTP,
     /status while the registry loads and when ready, two proves of the
     2^20 circuit and one of sqchain64 (each proof pairing-verified
     against its publics; add / scan_cols_packed / ntt_fused_pass
     launched in the first, ntt_fused_pass and no ntt_butterfly in the
     last), 404 for an
     unknown circuit, a request overwritten by the next one, and a body
     that is not JSON ending `failed`; plain field arithmetic or
     GLV.decompose on a CUDA tensor while the server loads and answers
     fails the phase (counted by a guard this script installs);
  8. generate bench_fixtures/sqchain2097152.{zkey,wtns} on the card and
     prove it through the CLI entry point (cold) and on the loaded
     Prover (warm): its MSM geometry, scans, adds and fused passes at
     shapes phase 2 held, both proofs pairing-verified; then generate
     bench_fixtures/sqchain4194304.{zkey,wtns} on the card
     (add_mixed_packed and add_mixed must have launched), prove it
     through the CLI entry point (cold), then on the loaded Prover
     (warm, fixed (r, s)); the proof must pairing-verify,
     scan_cols_packed must have launched once per slice per window
     group per MSM call, and add at the widths phase 2 timed;
     then, sharded: the same fixture proved by D = 2 and D = 4 ranks as
     processes of this script sharing the card (backend gloo, every
     exchange through host memory: no scaling number), each rank's proof
     byte-equal to the warm single-card proof, its plain field ops on
     the card 0 and every add, scan, fused NTT pass and four-step row
     product at a shape phase 2 held; each rank's JSON line (backend,
     points, slices, four-step shape, launches); with two or more cards
     also D = 2 over NCCL, a card a rank (not reached on one card);
     then the wide 2^22 circuit (fixtures.generate(extra=2^20 - 2^16):
     2^22 + 983,040 wires, its axis the plan's for that count, padding
     weighed) and the 2^23 sqchain (sequential NTTs), each generated,
     proved cold and
     warm as above and pairing-verified, the wide fixture deleted after
     its proves;
  9. generate bench_fixtures/sqchain16777216.{zkey,wtns} on the card (the
     smaller fixtures are deleted first; the machine's memory and disk
     and this process's resident memory are printed), prove it through
     the CLI entry point (cold, with the device peak of the Prover's
     set-up), then on the loaded Prover (warm, with the device peak of
     the front and of each MSM stage); both proofs
     must pairing-verify, and every scan, add and fused NTT pass must
     have run at a shape phase 2 checked; the warm prove has a fixed
     (r, s), and one more runs under torch.profiler after the lead
     spin kernels of device.traced (device kernels launched, the
     device-busy share of the prove and of the MSMs' window, its device
     ms by the port's wrappers and torch's, the front's kernels and
     digit_sort's by name; a torch sort or index gather in the MSMs
     fails the run, and so does a wrapper with fewer kernels in the
     trace after the lead, on the card's timeline, than its calls
     launched, as in every profiled prove of the run); no plain field
     arithmetic or GLV.decompose may run on a
     CUDA tensor in the CLI prove (set-up included), the warm prove and
     the K = 3 Prover's set-up and proves; fr_slot_acc on the Prover's
     own coefficient tables is held
     against its plain version and timed beside phase 2's random-index
     case. Then the same zkey with every coefficient record split in
     three distinct parts (v c1, v c2, v (1 - c1 - c2), made on the card
     by fr_pointwise) proves on a new Prover (K = 3 slots a row) with
     the same (r, s): its proof must equal the K = 1 proof byte for byte
     and pairing-verify, fr_slot_acc on its tables is held and timed as
     at K = 1, and its front's peak may exceed the K = 1
     front's by no more than the larger coefficient tables plus 1 GiB;
     the largest stage peak of the warm proves at K = 1 and K = 3 must
     stay within PEAK_LIMIT (40 GB); a `prove_2^24` JSON line. Then,
     sharded (the Provers released): the
     2^24 fixture on a one-rank NCCL mesh in this process (four-step NTTs
     at N1 = N2 = 2^12, the sharded MSMs) with the warm prove's (r, s),
     byte-equal to it, kernel shapes held and no plain field op on the
     card (set-up included), its phases, stage peaks and collective
     seconds; and the CLI in a subprocess with RSTPU_COORD /
     RSTPU_NPROCS=1 / RSTPU_PROC_ID=0, whose proof must pairing-verify;
     a `sharded` JSON line;
 10. the run's seconds, a `kernels` JSON line, the card line, and the
     result line last.

Bounds: bytes over 3.35 TB/s (each input read once, each output written
once) against 32-bit multiply-adds over the SMs' IMAD rate, 132 SMs x 64
per clock x 1.98 GHz = 16.7e12/s (H100 SXM; Hopper white paper). A
Montgomery product of 8 x 8 32-bit limbs is counted as 264 IMADs (two
64-product passes, a low and a high IMAD each, plus the 8 quotient
digits); additions are not counted. dma_gather does no arithmetic: its
bound is its bytes (rows read and written once, 4 bytes an index), and
so is gather_cols's; digit_sort's: an int64 key read, its sorted key,
permutation and sign written as int32, 4 bytes a bucket boundary. The
front kernels read each table once: fr_slot_acc a slot's 4-byte index
and 32-byte value (only the value of an empty slot), the witness once,
the spilled records' index and value, offsets and work list, and writes
32 bytes a row; one product a filled slot or spilled record. Beside that
bound it prints the traffic of one 32-byte sector a gathered witness row
(sector_ms): random indices cannot beat it once the witness outgrows the
50 MB L2.
"""

import contextlib
import ctypes
import hashlib
import json
import os
import random
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))

LOGN_BIG = 20
LOGN_WHOLE = 21     # a 1-bit top NTT pass
LOGN_SEG = 22       # the stacked NTT's largest; the sharded proves' size
LOGN_SEQ = 23       # sequential NTTs with a 3-bit top pass
LOGN_MAX = 24       # the production size, sliced, sequential NTTs
# the largest stage peak the 2^24 prove may reach under the plan (bytes)
PEAK_LIMIT = 40 * 10 ** 9
# the wide 2^22 circuit's extra wires: 2^22 + 2^20 - 2^16 points, which
# the Prover pads to whole slices of the plan's width
WIDE_EXTRA = (1 << 20) - (1 << 16)
GEN_LANES = 1 << 18  # scalars per fixed-base ladder chunk (fixtures._CH)
# the sharded proves: (log2 of the domain, ranks); 2^22 on ranks that share
# the one card over gloo, 2^24 on a one-rank NCCL mesh
SHARDED = ((LOGN_SEG, 2), (LOGN_SEG, 4), (LOGN_MAX, 1))


def log(*a):
    print(*a, flush=True)


# the port's kernel functions (csrc/*.cu) by the wrapper that launches
# them, first match wins: a profiled prove's device time by category
PORT_KERNEL_OF = (
    ("k_scan_g", "scan_cols_packed"), ("k_add_mixed", "add_mixed"),
    ("k_prefix_", "prefix_totals"),
    ("k_add_g", "add"), ("k_sort_", "digit_sort"),
    ("k_gather_cols", "gather_cols"), ("k_dma_gather", "dma_gather"),
    ("k_glv_digits", "glv_digits"), ("k_fq_scale", "fq_scale"),
    ("k_fused_pass", "ntt_fused_pass"), ("k_butterfly", "ntt_butterfly"),
    ("k_tail", "ntt_tail"), ("k_pointwise", "fr_pointwise"),
    ("k_slot_rows", "fr_slot_acc"), ("k_spill_", "fr_slot_acc"))
# a torch (not a port) kernel that sorts or gathers by index: none may run
# in a prove's MSMs
TORCH_ORDER = re.compile(
    r"(?i)sort|index_elementwise|indexselect|index_select|gather")


# Montgomery products in the code of one thread of each curve kernel (one
# add, or one scan column; a G2 lane's two threads each take two Fq
# products for each of its 12 / 11 Fq2 products, reduced together by one
# `mont2`), the divisor of its SASS counts
KERNEL_MONTS = {"k_add_g1": 17, "k_add_g2": 24, "k_scan_g1": 14,
                "k_scan_g2": 22, "k_add_mixed_g1": 11, "k_add_mixed_g2": 26}
SASS_LINE = re.compile(
    r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_report(exe_dir, libpath):
    """Per curve kernel of the built library: the SASS counts of IMAD*,
    IADD3* and all instructions (NOPs left out), each divided by the
    kernel's Montgomery products. Skipped, with a line, without
    cuobjdump."""
    exe = shutil.which("cuobjdump") or os.path.join(exe_dir, "cuobjdump")
    if not os.path.exists(exe):
        log("  sass: cuobjdump not found; SASS counts skipped")
        return
    out = subprocess.run([exe, "-sass", libpath], capture_output=True,
                         text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = Counter()
            continue
        m = SASS_LINE.search(line)
        if fn is None or m is None or m.group(1).startswith("NOP"):
            continue
        op = m.group(1)
        counts[fn]["all"] += 1
        for k in ("IMAD", "IADD3"):
            if op.startswith(k):
                counts[fn][k] += 1
    for fn, c in sorted(counts.items()):
        name = next((k for k in KERNEL_MONTS if k in fn), None)
        if name is None:
            continue
        m = KERNEL_MONTS[name]
        log(f"  sass[{fn}]: IMAD* {c['IMAD']} IADD3* {c['IADD3']} all "
            f"{c['all']}; per Montgomery product ({m}): IMAD* "
            f"{c['IMAD'] / m:.1f} IADD3* {c['IADD3'] / m:.1f} all "
            f"{c['all'] / m:.1f}")


def add_widths(rows, M):
    """{lanes: launches} of ops/fused.add in one ops/msm._window_group
    call over `rows` rows (window group x table rows) and 2^(c-1) = M
    buckets: _ps_at, diff, _tree_total (the chunk totals' prefix is
    prefix_totals, which launches no add)."""
    w = Counter()
    w[rows * (M + 1)] += 1
    w[rows * M] += 1
    size = M
    if size > 64 and not size & (size - 1):
        while size > 64:
            size //= 2
            w[rows * size] += 1
    w[rows * size] += (size - 1).bit_length() if size > 1 else 0
    return w


def rss_now() -> int:
    """This process's resident bytes (/proc/self/status VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class RssPeak:
    """The largest resident set of this process while the block runs,
    sampled every 50 ms on a thread (.peak, bytes)."""

    def __enter__(self):
        self.peak = rss_now()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.05):
            self.peak = max(self.peak, rss_now())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_now())


def machine(path):
    """The machine's memory (/proc/meminfo, bytes) and the disk that holds
    `path` (bytes)."""
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key = line.split(":")[0]
            if key in ("MemTotal", "MemAvailable"):
                mem[key] = int(line.split()[1]) * 1024
    du = shutil.disk_usage(path)
    return {**mem, "disk_total": du.total, "disk_free": du.free}


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def on_card(x):
    """Whether x (a tensor, or lists, tuples, dicts of them) holds a CUDA
    tensor."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (list, tuple)):
        return any(on_card(y) for y in x)
    if isinstance(x, dict):
        return any(on_card(y) for y in x.values())
    return False


@contextlib.contextmanager
def plain_calls():
    """Count, by name, the plain field arithmetic (FieldOps: products,
    sums, inversions) and GLV.decompose calls on CUDA tensors made while
    the block runs; yields the Counter."""
    from rapidsnark_tpu_torch.ops import field as FF, glv as GLVM
    targets = [(FF.FieldOps, n) for n in (
        "add", "sub", "neg", "double", "canon", "add_lazy", "mul",
        "mul_many", "cond_sub_2p", "add_rx", "dadd_rx", "sub_rx", "neg_rx",
        "from_mont", "to_mont", "reduce_wide")] + [(GLVM, "decompose")]
    calls = Counter()
    before = {(o, n): getattr(o, n) for o, n in targets}

    def counting(n, fn):
        def run(*args, **kw):
            if on_card(args) or on_card(kw):
                calls[n] += 1
            return fn(*args, **kw)
        return run

    for (o, n), fn in before.items():
        setattr(o, n, counting(n, fn))
    try:
        yield calls
    finally:
        for (o, n), fn in before.items():
            setattr(o, n, fn)


@contextlib.contextmanager
def shape_log():
    """The shapes every add, scan, fused NTT pass, fr_pointwise call and
    bucket-ordering call runs at while the block runs: yields {"add":
    Counter((G1?, lanes)), "scan": Counter((G1?, K, lanes)), "pass":
    Counter((batch, n, lo, k, dif, pre_mul?)), "pointwise": Counter((op,
    elements, b's elements)), "sort": Counter((c, rows, n)) of digit_sort,
    "gathercols": Counter((A, table rows, G, n)) of gather_cols,
    "rowgather": Counter((table rows, words, m)) of dma_gather,
    "prefix": Counter((G1?, rows, nb)) of prefix_totals}."""
    from rapidsnark_tpu_torch.ops import front, fused, msm
    from rapidsnark_tpu_torch.ops.curve import G1P
    seen = {k: Counter() for k in ("add", "scan", "pass", "pointwise",
                                   "sort", "gathercols", "rowgather",
                                   "prefix")}
    real = (fused.add, fused.scan_cols_packed, fused.ntt_fused_pass,
            front.fr_pointwise, msm.digit_sort, msm.gather_cols,
            fused.dma_gather, fused.prefix_totals)

    def add(curve, p, q):
        seen["add"][(curve is G1P, p.numel() // (p.shape[-2] * 8))] += 1
        return real[0](curve, p, q)

    def scan(curve, acc, cols, sign):
        seen["scan"][(curve is G1P, cols.shape[0],
                      acc.numel() // (acc.shape[-2] * 8))] += 1
        return real[1](curve, acc, cols, sign)

    def fused_pass(x, tw, lo_bit, nbits, dif, pre_mul=None):
        seen["pass"][(x.shape[0], x.shape[1], lo_bit, nbits, bool(dif),
                      pre_mul is not None)] += 1
        return real[2](x, tw, lo_bit, nbits, dif, pre_mul)

    def pointwise(op, a, b, c=None):
        seen["pointwise"][(op, a.numel() // 8, b.numel() // 8)] += 1
        return real[3](op, a, b, c)

    def digit_sort(digits, c):
        n = digits.shape[-1]
        seen["sort"][(c, digits.numel() // n, n)] += 1
        return real[4](digits, c)

    def gather_cols(pts, perm):
        n, A = pts.shape[-3], pts.shape[-2]
        seen["gathercols"][(A, pts.numel() // (n * A * 8), perm.shape[0],
                            n)] += 1
        return real[5](pts, perm)

    def dma_gather(table, idx, blk=512, nsem=16):
        seen["rowgather"][(table.shape[0], table.shape[1],
                           idx.shape[0])] += 1
        return real[6](table, idx, blk, nsem)

    def prefix_totals(curve, tot):
        nb = tot.shape[-3]
        seen["prefix"][(curve is G1P, tot.numel() // (nb * tot.shape[-2] * 8),
                        nb)] += 1
        return real[7](curve, tot)

    (fused.add, fused.scan_cols_packed, fused.ntt_fused_pass,
     front.fr_pointwise, msm.digit_sort, msm.gather_cols,
     fused.dma_gather, fused.prefix_totals) = (
         add, scan, fused_pass, pointwise, digit_sort, gather_cols,
         dma_gather, prefix_totals)
    try:
        yield seen
    finally:
        (fused.add, fused.scan_cols_packed, fused.ntt_fused_pass,
         front.fr_pointwise, msm.digit_sort, msm.gather_cols,
         fused.dma_gather, fused.prefix_totals) = real


def rank_main(argv) -> int:
    """One rank of a sharded prove, as the sharded phases start it:
        chip_smoke.py --rank <ranks> <rank> <host:port> <backend> <zkey>
            <wtns> <outdir> <r> <s>
    proves on the rank's card through tools/dist_prove_worker, counting
    the shapes of the kernels' launches and any plain field op on the
    card (set-up included), and prints the rank's JSON line, the proof
    included."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from rapidsnark_tpu_torch.tools import dist_prove_worker
    nd, rank, coord, backend, zpath, wpath, outdir, r, s = argv
    os.environ.update(RSTPU_COORD=coord, RSTPU_NPROCS=nd, RSTPU_PROC_ID=rank)
    with plain_calls() as plain, shape_log() as seen:
        out = dist_prove_worker.prove_rank(zpath, wpath, outdir, int(r),
                                           int(s), "cuda", backend)
    out["seen"] = {k: [list(key) + [v] for key, v in c.items()]
                   for k, c in seen.items()}
    out["plain_on_card"] = dict(plain)
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "rapidsnark_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    from rapidsnark_tpu_torch import cli, config, device as D, fixtures
    from rapidsnark_tpu_torch.io.wtns import read_wtns
    from rapidsnark_tpu_torch.io.zkey import read_zkey, zkey_to_ref
    from rapidsnark_tpu_torch.ops import field as FF, fused, msm as MSM
    from rapidsnark_tpu_torch.ops import front as FRONT
    from rapidsnark_tpu_torch.ops import glv as GLVM
    from rapidsnark_tpu_torch.ops import ntt as TN
    from rapidsnark_tpu_torch.ops.ntt import _passes
    from rapidsnark_tpu_torch.ops.curve import G1P, G2P, G2P_ISO
    from rapidsnark_tpu_torch.ops.glv import GLV_BITS
    from rapidsnark_tpu_torch.prover import Prover, host_g1, host_g2
    from rapidsnark_tpu_torch.ref.field import P, R_FR
    from rapidsnark_tpu_torch.ref.groth16 import Proof, verify
    from rapidsnark_tpu_torch.ref.groth16 import prove as ref_prove
    from rapidsnark_tpu_torch.utils.limbs import words_to_ints
    from rapidsnark_tpu_torch.server import http as server_http
    from rapidsnark_tpu_torch.server.__main__ import main as server_main
    from rapidsnark_tpu_torch.parallel import multihost as MH, pmsm as PM
    from rapidsnark_tpu_torch.tools import (
        HBM_BYTES_PER_S, MONT_IMADS, bench_dma_gather, bench_fq_scale,
        bench_gather, bench_msm_phases, bound_ms, card_line, device_time,
        dist_prove_worker, msm_ablate, scan_add_imads, sweep_msm)
    from rapidsnark_tpu_torch.utils.hostcurve import G1H, G2H

    t_run = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])

    # ---------------------------------------------------------- phase 1 --
    t0 = time.perf_counter()
    logs = D.build(force=True)
    build_s = time.perf_counter() - t0
    log(f"phase1 build: {build_s:.2f}s for {sorted(logs)}")
    ptxas = {}                  # kernel -> its registers and spill lines
    for src, text in logs.items():
        fn = None
        for line in text.splitlines():
            m = re.search(r"(?:entry function|properties for) '?(\w+)", line)
            if m:
                fn = m.group(1)
            elif "registers" in line or "spill" in line:
                info = line.split('ptxas info    :')[-1].strip()
                log(f"  ptxas[{src}] {fn}: {info}")
                ptxas.setdefault(fn, []).append(info)
    fq_ptxas = [v for k, v in ptxas.items() if "k_fq_scale" in k]
    log(f"phase1 fq_scale (k_fq_scale): {fq_ptxas}")
    nv = subprocess.run([D.nvcc(), "--version"], capture_output=True,
                        text=True, timeout=60)
    log("phase1 nvcc --version:", " | ".join(
        ln.strip() for ln in nv.stdout.splitlines() if ln.strip()))
    sass_report(os.path.dirname(D.nvcc()),
                os.path.join(D.BUILD, "libcurve.so"))
    front_lib = D.lib("front")
    for what, which, K in (("k_slot_rows K=1", 0, 1),
                           ("k_slot_rows K=3", 0, 3),
                           ("k_spill_items", 1, 0), ("k_spill_rows", 2, 0)):
        per_sm = ctypes.c_int(0)
        D.check(front_lib.rs_front_occupancy(which, K,
                                             ctypes.addressof(per_sm)),
                "rs_front_occupancy")
        log(f"  occupancy[{what}]: {per_sm.value} blocks of 256 threads "
            f"an SM ({8 * per_sm.value} warps)")

    # ---------------------------------------------------------- phase 2 --
    rng = np.random.RandomState(2024)

    def fe(mod, shape):
        """Random canonical elements as packed int32 words (*shape, 8)."""
        w = rng.randint(0, 1 << 32, size=tuple(shape) + (8,),
                        dtype=np.uint64)
        w[..., 7] %= mod >> 224
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)

    def canon_words(curve, t):
        """G1 relaxed coordinates -> canonical words (mod p)."""
        if curve is not G1P:
            return t
        return FF.pack(FF.FQ.canon(FF.unpack(t)))

    def err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    def err_mod(curve, a, b):
        """Largest word difference after reducing G1 coordinates mod p,
        in slices of the leading axis (the scan outputs are GBs)."""
        if torch.equal(a, b):
            return 0
        step = max(1, a.shape[0] // 64)
        return max(err(canon_words(curve, a[i:i + step]),
                       canon_words(curve, b[i:i + step]))
                   for i in range(0, a.shape[0], step))

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def timed2(fn, reps):
        """(wrapper ms, (device ms, method)) a call of fn: CUDA events
        around reps eager calls (host work included), and reps calls
        captured in one CUDA graph (tools.device_time; the profiler's
        kernel durations where a call cannot be captured)."""
        return timed(fn, reps), device_time(fn, reps)

    def timed_once(fn):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    results = {}
    failures = []

    def record(name, key, e, ms, dev_t, plain_ms, nbytes, imads,
               library_ms=None, **extra):
        """One timed case: ms through the wrapper, dev_t = (device ms,
        method) from timed2; the share of the bound is the device
        time's. `extra` (launches, geometry) joins its entry. Returns the
        bound in ms."""
        b, by = bound_ms(nbytes, imads)
        dms, how = dev_t
        ent = results.setdefault(name, {"max_abs_err": 0, "cases": []})
        ent["max_abs_err"] = max(ent["max_abs_err"], e)
        ent["cases"].append({"case": key, "ms": ms, "device_ms": dms,
                             "device_method": how, "plain_ms": plain_ms,
                             "bound_ms": b, "bound_by": by,
                             "library_ms": library_ms, **extra})
        log(f"  {name}[{key}]: err {e} kernel {ms:.4f} ms device "
            f"{dms:.4f} ms ({how}) plain {plain_ms} ms bound {b:.4f} ms "
            f"({by}) share {b / dms:.3f}"
            + ("" if library_ms is None else f" library {library_ms:.4f} ms")
            + "".join(f" {k} {v}" for k, v in extra.items()))
        if e != 0:
            failures.append(f"{name}[{key}] disagrees (max err {e})")
        return b

    def check_only(name, key, e):
        ent = results.setdefault(name, {"max_abs_err": 0, "cases": []})
        ent["max_abs_err"] = max(ent["max_abs_err"], e)
        log(f"  {name}[{key}]: err {e}")
        if e != 0:
            failures.append(f"{name}[{key}] disagrees (max err {e})")

    # the MSM geometry of every prove this run makes: config.msm_plan's
    # for the rank's axis and the ranks sharing this card. Phase 2 holds
    # every scan, add, glv_digits and fq_scale case at each one's shapes;
    # a prove fails unless it ran its entry's geometry.
    card_mem = torch.cuda.get_device_properties(0).total_memory

    def plan_geo(npts, ranks=1):
        """The MSM of a rank's axis of npts points: segment (0: the whole
        axis), c, window group G, window groups, the padded nmax, the
        entries a slice (width) and the slices; a slice's scans have
        G x rows x width / 256 lanes; add's widths per slice
        (_window_group on both curves once per window group, then, when
        sliced, one point per window into the running totals)."""
        s, cc, g0 = config.msm_plan(npts, 4, ranks, card_mem)
        nw = -(-GLV_BITS // cc)
        gg = MSM.group_size(nw, g0)
        nmax = PM.pad_len_sharded(npts, 1, s)
        width = s if s and s < 2 * nmax else 2 * nmax
        adds = {}
        for curve, rows in ((G1P, 4), (G2P_ISO, 1)):
            sl = Counter()
            for _ in range(nw // gg):
                sl.update(add_widths(gg * rows, 1 << (cc - 1)))
                if width < 2 * nmax:
                    sl[gg * rows] += 1
            adds[curve] = sl
        nb = width // 256
        return {"segment": s, "c": cc, "G": gg, "groups": nw // gg,
                "nmax": nmax, "width": width, "slices": 2 * nmax // width,
                "lanes": {G1P: gg * 4 * nb, G2P_ISO: gg * nb},
                "adds": adds}

    geo = {f"2^{lg}": plan_geo(1 << lg) for lg in
           (LOGN_BIG, LOGN_WHOLE, LOGN_SEG, LOGN_SEQ, LOGN_MAX)}
    geo["wide"] = plan_geo((1 << LOGN_SEG) + WIDE_EXTRA)
    for logn, nd in SHARDED:
        if nd > 1:
            geo[f"2^{logn} D={nd}"] = plan_geo((1 << logn) // nd, nd)
    for k, g in geo.items():
        log(f"  MSM geometry {k}: " + json.dumps(
            {a: b for a, b in g.items() if a not in ("lanes", "adds")}))
    # the 2^20 prove's widest add (its _ps_at over the buckets), the main
    # shape of add's cases
    g20 = geo[f"2^{LOGN_BIG}"]
    add_lanes = {G1P: g20["G"] * 4 * ((1 << (g20["c"] - 1)) + 1),
                 G2P_ISO: g20["G"] * ((1 << (g20["c"] - 1)) + 1)}
    # add's widths and launches a slice (a whole axis is one slice) of
    # each prove, and the sharded MSM's cross-rank sum: the D ranks'
    # window totals of a curve in one running-sum pass, log2(D) adds over
    # W x rows x D lanes
    add_launches = {curve: {k: g["adds"][curve] for k, g in geo.items()}
                    for curve in (G1P, G2P_ISO)}
    for logn, nd in SHARDED:
        if nd > 1:
            nw = -(-GLV_BITS // geo[f"2^{logn} D={nd}"]["c"])
            for curve, rows in ((G1P, 4), (G2P_ISO, 1)):
                add_launches[curve][f"2^{logn} D={nd} cross-rank sum"] = \
                    Counter({nw * rows * nd: (nd - 1).bit_length()})
    coords = {G1P: 3, G2P_ISO: 6, G2P: 6}
    mont_add = {G1P: 17, G2P_ISO: 36}

    curve_lib = D.lib("curve")
    curve_lib.rs_curve_geometry.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    curve_lib.rs_curve_geometry.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def geometry(op, curve, n):
        """The launch of rs_add (op 0) / rs_scan_cols (op 1) /
        rs_add_mixed_packed (op 2) / rs_add_mixed (op 3) for n lanes:
        threads a block, blocks, resident blocks per SM, waves."""
        buf = (ctypes.c_int * 3)()
        cid = (fused._mixed_curve_id if op >= 2 else fused._curve_id)(curve)
        rc = curve_lib.rs_curve_geometry(op, cid, n, buf)
        if rc:
            raise RuntimeError(f"rs_curve_geometry failed with error {rc}")
        threads, blocks, per_sm = buf
        return {"threads": threads, "blocks": blocks,
                "blocks_per_sm": per_sm,
                "waves": blocks / (per_sm * sms) if per_sm else None}

    def same_points(curve, a, b):
        """Projective points a, b (..., L, 8) are the same points (X1 Z2 =
        X2 Z1, Y1 Z2 = Y2 Z1, Z1 = 0 where Z2 = 0; G1 words mod p), by
        the plain field ops on the card."""
        from rapidsnark_tpu_torch.ops.curve import pack_point, unpack_point
        f = curve.f
        (x1, y1, z1), (x2, y2, z2) = (unpack_point(curve, a),
                                      unpack_point(curve, b))
        one = f.one_mont(tuple(a.shape[:-2]), a.device)

        def words(u, v):
            return pack_point((f.mul(u, v),))

        def zero(z):
            return (words(z, one) == 0).flatten(-2).all(-1)

        return (torch.equal(words(x1, z2), words(x2, z1))
                and torch.equal(words(y1, z2), words(y2, z1))
                and torch.equal(zero(z1), zero(z2)))

    # 64 multiples of each generator, projective with z = 1: the points
    # behind prefix_totals' cases (G2 on the iso-twist)
    ks = torch.zeros((64, 8), dtype=torch.int32, device=dev)
    ks[:, 0] = torch.arange(1, 65, dtype=torch.int32, device=dev) * 7919
    one_z = torch.from_numpy(np.array(
        [(((1 << 256) % P) >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
        dtype=np.uint32).view(np.int32)).to(dev)
    bases = {}
    for curve, aff in ((G1P, torch.from_numpy(
            fixtures.fixed_base_g1(ks).view(np.int32)).to(dev)),
            (G2P_ISO, MSM.g2_rescale_packed(torch.from_numpy(
                fixtures.fixed_base_g2(ks).view(np.int32)).to(dev)))):
        z = torch.zeros((64, aff.shape[1] // 2, 8), dtype=torch.int32,
                        device=dev)
        z[:, 0] = one_z
        bases[curve] = torch.cat([aff, z], dim=1)

    def curve_rows(curve, rows, nb):
        """(rows, nb, L, 8): the bases drawn at random, every 7th
        infinity."""
        idx = torch.from_numpy(rng.randint(0, 64, size=(rows, nb))).to(dev)
        pts = bases[curve][idx]
        flat = pts.view(-1, pts.shape[-2], 8)
        flat[::7] = 0
        flat[::7, pts.shape[-2] // 3] = one_z
        return pts

    log("phase2: kernels vs plain versions")
    for curve, tag in ((G1P, "g1"), (G2P_ISO, "g2")):
        L = coords[curve]
        # add: a small random batch, then every width a 2^20 prove and a
        # 2^22 or 2^24 slice launch it at (the main shape first), each with
        # its launches there
        runs_n = add_launches[curve]
        shapes = sorted(set().union(*runs_n.values()) | {add_lanes[curve]},
                        reverse=True)
        shapes.remove(add_lanes[curve])
        per_run = {r: [0, 0.0, 0.0, 0.0, 0.0] for r in runs_n}
        for n in [1000, add_lanes[curve]] + shapes:
            p, q = fe(P, (n, L)), fe(P, (n, L))
            want, plain_ms = timed_once(lambda: fused.add_plain(curve, p, q))
            got = fused.add(curve, p, q)
            torch.cuda.synchronize()
            e = err_mod(curve, got, want)
            if n == 1000:
                check_only("add", f"{tag} n={n}", e)
                continue
            # the kernel alone: its C entry point back to back (a narrow
            # launch takes less time than the wrapper's Python); then
            # through the wrapper, as ops/msm calls it
            reps = 20 if n >= 40960 else 200
            args = (fused._curve_id(curve), p.data_ptr(), q.data_ptr(),
                    got.data_ptr(), n, D.stream(p))
            D.check(curve_lib.rs_add(*args), "add")
            ms = timed(lambda: curve_lib.rs_add(*args), reps)
            call_ms, dev_t = timed2(lambda: fused.add(curve, p, q), reps)
            launches = {r: cnt[n] for r, cnt in runs_n.items()}
            b = record("add", f"{tag} n={n}", e, ms, dev_t, plain_ms,
                       3 * n * L * 32, n * mont_add[curve] * MONT_IMADS,
                       call_ms=call_ms, launches=launches,
                       **geometry(0, curve, n))
            for r, k in launches.items():
                per_run[r][0] += k
                per_run[r][1] += k * ms
                per_run[r][2] += k * b
                per_run[r][3] += k * call_ms
                per_run[r][4] += k * dev_t[0]
        for r, (k, t, b, c, d) in per_run.items():
            log(f"  add {tag} per {r}: {k} launches {t:.4f} ms, bound "
                f"{b:.4f} ms, launches x (ms - bound) {t - b:.4f} ms; "
                f"through the wrapper {c:.4f} ms; on the device {d:.4f} "
                f"ms (launches x (device ms - bound) {d - b:.4f} ms)")
        # scan_cols_packed: K in {1, 2, 256}, signs set, some infinities
        A = L - L // 3
        # the 2^20 prove's lanes first: the main case of the kernels line
        for K, n in ((1, 1000), (2, 1000), (256, 1000)) + tuple(
                (256, n) for n in dict.fromkeys(g["lanes"][curve]
                                                for g in geo.values())):
            acc = fe(P, (n, L))
            cols = fe(P, (K, n, A))
            cols[:, ::7] = 0                       # (0,0) = infinity
            sign = torch.from_numpy(
                rng.randint(0, 2, size=(K, n)).astype(np.int32)).to(dev)
            want, plain_ms = timed_once(
                lambda: fused.scan_cols_plain(curve, acc, cols, sign))
            got = fused.scan_cols_packed(curve, acc, cols, sign)
            torch.cuda.synchronize()
            e = err_mod(curve, got, want)
            del want, got
            if n == 1000:
                check_only("scan_cols_packed", f"{tag} K={K} n={n}", e)
                continue
            ms, dev_t = timed2(lambda: fused.scan_cols_packed(
                curve, acc, cols, sign), 3)
            record("scan_cols_packed", f"{tag} K={K} n={n}", e, ms, dev_t,
                   plain_ms,
                   n * L * 32 + K * n * (A * 32 + 4 + L * 32),
                   K * n * scan_add_imads(tag),
                   **geometry(1, curve, n))
            del acc, cols, sign
        # prefix_totals: a window group's chunk totals at every geometry
        # (rows of nb = width / 256), and 3 rows of one and of 1000
        # totals (checked only): 64 multiples of the generator drawn at
        # random, every 7th infinity; held against the plain version (the
        # two-level Hillis of `add`s on the card) as points, its bound the
        # complete adds of a sequential prefix, nb - 2 a row
        rows_of = 4 if curve is G1P else 1
        shapes = {(g["G"] * rows_of, g["width"] // 256): {
            k: 2 * h["slices"] * h["groups"] for k, h in geo.items()
            if (h["G"], h["width"]) == (g["G"], g["width"])}
            for g in geo.values()}
        for (rows, nb), launches in [((3, 1), None), ((3, 1000), None)] + \
                sorted(shapes.items()):
            tot = curve_rows(curve, rows, nb)
            want, plain_ms = timed_once(
                lambda: fused.prefix_totals_plain(curve, tot))
            got = fused.prefix_totals(curve, tot)
            torch.cuda.synchronize()
            e = int(not same_points(curve, got, want))
            del want, got
            key = f"{tag} {rows} x {nb}"
            if launches is None:
                check_only("prefix_totals", key, e)
                continue
            ms, dev_t = timed2(lambda: fused.prefix_totals(curve, tot), 10)
            record("prefix_totals", key, e, ms, dev_t, plain_ms,
                   2 * rows * nb * L * 32,
                   rows * max(nb - 2, 0) * mont_add[curve] * MONT_IMADS,
                   launches=launches)
            del tot
        torch.cuda.empty_cache()

    # the strict mixed adds of the fixture generator: a small batch with
    # (0,0) lanes and lanes where q = p and q = -p (z = 1), then the
    # ladder's chunk of 2^18 lanes
    one = torch.from_numpy(np.array(
        [(((1 << 256) % P) >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
        dtype=np.uint32).view(np.int32)).to(dev)
    mont_strict = {G1P: 11, G2P: 39}

    def to_limbs(q):
        """(n, A, 8) packed words -> (n, A, 16), one 16-bit limb a word."""
        w = q.to(torch.int64) & 0xFFFFFFFF
        return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
            q.shape[:-1] + (16,)).to(torch.int32).contiguous()

    for curve, tag in ((G1P, "g1"), (G2P, "g2")):
        L = coords[curve]
        A = L - L // 3
        for n in (1000, GEN_LANES):
            p, q = fe(P, (n, L)), fe(P, (n, A))
            if n == 1000:
                q[::7] = 0                             # (0,0) = infinity
                dbl = torch.arange(2, n, 5, device=dev)
                neg = torch.arange(3, n, 5, device=dev)
                for lanes in (dbl, neg):
                    p[lanes, A:] = 0
                    p[lanes, A] = one                  # z = 1
                    p[lanes, :A] = q[lanes]            # p = q
                q[neg, A // 2:] = FF.pack(FF.FQ.neg(
                    FF.unpack(q[neg, A // 2:])))       # q = -p
            for op, name, kern, plain, qq, qbytes in (
                    (2, "add_mixed_packed", fused.add_mixed_packed,
                     fused.add_mixed_packed_plain, q, A * 32),
                    (3, "add_mixed", fused.add_mixed, fused.add_mixed_plain,
                     to_limbs(q), A * 64)):
                want, plain_ms = timed_once(lambda: plain(curve, p, qq))
                got = kern(curve, p, qq)
                torch.cuda.synchronize()
                e = err(got, want)
                if n == 1000:
                    check_only(name, f"{tag} n={n}", e)
                    continue
                ms, dev_t = timed2(lambda: kern(curve, p, qq), 20)
                record(name, f"{tag} n={n}", e, ms, dev_t, plain_ms,
                       n * (2 * L * 32 + qbytes),
                       n * mont_strict[curve] * MONT_IMADS,
                       **geometry(op, curve, n))
        torch.cuda.empty_cache()

    # NTT kernels: Fr elements. The fused passes of the 2^20 prove, then
    # every pass of the 2^21 and 2^22 proves' two transforms (DIF
    # top-down, DIT bottom-up with the coset pre-multiply on its first
    # pass) over the 3-stack, and of the 2^23 and 2^24 proves' over one
    # polynomial (sequential): top passes of 1, 2, 3 and 4 bits
    ntt_checked = set()      # (batch, n, lo, k, dif, pre_mul) held here

    def pass_cases(logn, cases, batch=3, check_rows=None):
        """Each (lo, k, dif, pre_mul) pass over (batch, 2^logn) held
        against the plain version (on the first check_rows polynomials
        when given: each is transformed on its own) and timed."""
        n = 1 << logn
        x, tw, pm = fe(R_FR, (batch, n)), fe(R_FR, (n // 2,)), fe(R_FR, (n,))
        sub = batch if check_rows is None else min(batch, check_rows)
        extra = {} if sub == batch else {"plain_rows": sub}
        for lo, k, dif, pre in cases:
            pmul = pm if pre else None
            ntt_checked.add((batch, n, lo, k, dif, pre))
            key = f"{batch} x 2^{logn} bits {lo}+{k} " \
                f"{'dif' if dif else 'dit'}" + (" pre_mul" if pre else "")
            want, plain_ms = timed_once(lambda: fused.ntt_fused_pass_plain(
                x[:sub], tw, lo, k, dif, pmul))
            got = fused.ntt_fused_pass(x, tw, lo, k, dif, pmul)
            torch.cuda.synchronize()
            e = err(got[:sub], want)
            del want, got
            ms, dev_t = timed2(lambda: fused.ntt_fused_pass(
                x, tw, lo, k, dif, pmul), 10)
            elems = batch * n
            nbytes = 2 * elems * 32 + (1 << (lo + k - 1)) * 32 + \
                (n * 32 if pre else 0)
            imads = (elems // 2 * k + (elems if pre else 0)) * MONT_IMADS
            record("ntt_fused_pass", key, e, ms, dev_t, plain_ms, nbytes,
                   imads, **extra)
        return x, tw

    for logn in (LOGN_WHOLE, LOGN_SEG, LOGN_SEQ, LOGN_MAX):
        batch = 1 if config.ntt_sequential(logn) else 3
        x, tw = pass_cases(logn,
                           [(lo, k, True, False) for lo, k in _passes(logn)] +
                           [(lo, k, False, lo == 0) for lo, k in _passes(logn)],
                           batch)
        del x, tw
        torch.cuda.empty_cache()
    # the four-step NTT's column and row transforms (parallel/pntt): 3 x c2
    # polynomials of N1 = N2 points, c2 = N2 / D; both twiddle directions
    # run the DIT passes after ops/ntt.ntt's bit reversal; the DIF passes
    # and the pre-multiply are held too
    for logn, nd in SHARDED:
        p1 = (logn + 1) // 2
        c2_ = (1 << (logn - p1)) // nd
        passes = _passes(p1)
        x, tw = pass_cases(p1, [(lo, k, False, False) for lo, k in passes] +
                           [(lo, k, True, False) for lo, k in passes] +
                           [(0, passes[0][1], False, True)],
                           batch=3 * c2_, check_rows=256)
        del x, tw
        torch.cuda.empty_cache()
    N = 1 << LOGN_BIG
    x, tw = pass_cases(LOGN_BIG, ((0, 10, False, True), (0, 10, True, False),
                                  (10, 5, False, False), (15, 5, True, False)))
    # ntt_tail at the per-stage prove's shape, also held against the
    # same seven layers as one fused pass
    for dif in (True, False):
        key = f"3 x 2^{LOGN_BIG} {'dif' if dif else 'dit'}"
        want, plain_ms = timed_once(lambda: fused.ntt_tail_plain(x, tw, dif))
        got = fused.ntt_tail(x, tw, dif)
        same = fused.ntt_fused_pass(x, tw, 0, fused.TAIL_BITS, dif)
        torch.cuda.synchronize()
        check_only("ntt_tail", key + " vs ntt_fused_pass", err(got, same))
        pass_ms = timed(lambda: fused.ntt_fused_pass(
            x, tw, 0, fused.TAIL_BITS, dif), 10)
        log(f"  ntt_fused_pass[bits 0+{fused.TAIL_BITS} "
            f"{'dif' if dif else 'dit'}]: kernel {pass_ms:.4f} ms")
        ms, dev_t = timed2(lambda: fused.ntt_tail(x, tw, dif), 10)
        record("ntt_tail", key, err(got, want), ms, dev_t, plain_ms,
               2 * 3 * N * 32 + 127 * 32,
               3 * N // 2 * fused.TAIL_BITS * MONT_IMADS)
    del x, tw, want, got, same
    # sqchain64's NTTs: domain 128, the (3, 128) stack -> 3 * 64 pairs
    # per layer; 3072 pairs checks a wider launch; 3 * 2^19 pairs are the
    # upper layers of the per-stage 2^20 prove
    for n in (3 * 64, 3072, 3 << (LOGN_BIG - 1)):
        lo_, hi_, tw_ = fe(R_FR, (n,)), fe(R_FR, (n,)), fe(R_FR, (n,))
        for dif in (False, True):
            want, plain_ms = timed_once(
                lambda: fused.ntt_butterfly_plain(lo_, hi_, tw_, dif))
            got = fused.ntt_butterfly(lo_, hi_, tw_, dif)
            torch.cuda.synchronize()
            e = max(err(got[0], want[0]), err(got[1], want[1]))
            tag = f"n={n} {'dif' if dif else 'dit'}"
            if n == 3072:
                check_only("ntt_butterfly", tag, e)
                continue
            ms, dev_t = timed2(lambda: fused.ntt_butterfly(lo_, hi_, tw_,
                                                           dif),
                               50 if n == 3 * 64 else 10)
            record("ntt_butterfly", tag, e, ms, dev_t, plain_ms, 5 * n * 32,
                   n * MONT_IMADS)
    torch.cuda.empty_cache()

    # the small transforms: the default dispatch below 2^12 (fused passes,
    # one a direction up to 2^10) through ops/ntt's stage functions, held
    # against the per-layer path's plain arithmetic on the card and timed
    # beside the per-layer kernels (RSTPU_NTT_FUSE=0: one ntt_butterfly a
    # layer, the coset multiply by fr_pointwise)
    def per_layer_plain(x, tw, dif, pre_mul=None):
        bsz, n = x.shape[0], x.shape[1]
        if pre_mul is not None:
            x = FRONT.fr_pointwise_plain("mul", x, pre_mul)
        bits = range(n.bit_length() - 1)
        for bit in (reversed(bits) if dif else bits):
            h = 1 << bit
            xv = x.reshape(bsz, n // (2 * h), 2, h, 8)
            twl = fused.stage_twiddles(tw, n, bit).expand(xv[:, :, 0].shape)
            lo_, hi_ = fused.ntt_butterfly_plain(xv[:, :, 0], xv[:, :, 1],
                                                 twl, dif)
            x = torch.stack([lo_, hi_], dim=2).reshape(bsz, n, 8)
        return x

    def both_ways(fn, reps):
        """fn's ms per call under RSTPU_NTT_FUSE=0 and by default, timed
        in turns (per layer, fused, fused, per layer)."""
        t = {"per_layer": [], "fused": []}
        for way in ("per_layer", "fused", "fused", "per_layer"):
            if way == "per_layer":
                os.environ["RSTPU_NTT_FUSE"] = "0"
            try:
                t[way].append(timed(fn, reps))
            finally:
                os.environ.pop("RSTPU_NTT_FUSE", None)
        return {k: min(v) for k, v in t.items()}

    small_ntt = {}
    for batch, logn in ((3, 7), (1, 10), (1, 11)):
        n = 1 << logn
        plan = TN.NTTPlan(logn, dev).tensors()
        x = fe(R_FR, (batch, n))
        for dif in (True, False):
            tw = plan["inv_tw" if dif else "fwd_tw"]
            pm = None if dif else plan["coset_ninv_br"]
            passes = _passes(logn)
            for lo, k in passes:
                ntt_checked.add((batch, n, lo, k, dif,
                                 pm is not None and lo == 0))
            if dif:
                fn = lambda: TN._stages_dif(x, tw)              # noqa: E731
            else:
                fn = lambda: TN._stages_dit(x, tw, pre_mul=pm)  # noqa: E731
            D.reset_counts()
            got = fn()
            torch.cuda.synchronize()
            if (D.counts["ntt_fused_pass"], D.counts["ntt_butterfly"]) != \
                    (len(passes), 0):
                raise RuntimeError(f"a 2^{logn}-point transform made "
                                   f"{dict(D.counts)} launches")
            want, plain_ms = timed_once(
                lambda: per_layer_plain(x, tw, dif, pm))
            e = err(got, want)
            ways = both_ways(fn, 200)
            elems = batch * n
            key = f"{batch} x 2^{logn} whole {'dif' if dif else 'dit'}" + \
                ("" if dif else " pre_mul")
            record("ntt_fused_pass", key, e, ways["fused"],
                   device_time(fn, 200), plain_ms,
                   2 * elems * 32 + n // 2 * 32 + (0 if dif else n * 32),
                   (elems // 2 * logn + (0 if dif else elems)) * MONT_IMADS,
                   launches_per_direction=len(passes),
                   per_layer_ms=ways["per_layer"])
    # whole transforms through the port's functions, sqchain64's shapes
    plan = TN.NTTPlan(7, dev).tensors()
    x3, x1 = fe(R_FR, (3, 128)), fe(R_FR, (128,))
    for name, fn in (("to_odd_coset 3 x 128",
                      lambda: TN.to_odd_coset(x3, plan)),
                     ("inverse ntt 128", lambda: TN.ntt(x1, plan, True))):
        small_ntt[name] = both_ways(fn, 200)
        log(f"  {name}: fused {small_ntt[name]['fused']:.4f} ms, per layer "
            f"{small_ntt[name]['per_layer']:.4f} ms a call (200 calls)")
    del x, x3, x1, plan, got, want

    # dma_gather: rows of R words by a permutation and by an index vector
    # that repeats rows, at the tool's default shape and at the 2^20
    # prove's GLV axis of G1 (64-byte) and G2 (128-byte) rows; exact words
    for glogn, R in ((18, 16), (LOGN_BIG + 1, 16), (LOGN_BIG + 1, 32)):
        gn = 1 << glogn
        table = torch.from_numpy(rng.randint(
            0, 2**31, size=(gn, R), dtype=np.int64).astype(np.int32)).to(dev)
        for kind, idx_np in (("perm", rng.permutation(gn)),
                             ("repeats", rng.randint(0, gn // 8, size=gn))):
            idx = torch.from_numpy(idx_np.astype(np.int32)).to(dev)
            idx64 = idx.long()
            want, plain_ms = timed_once(
                lambda: fused.dma_gather_plain(table, idx))
            got = fused.dma_gather(table, idx)
            torch.cuda.synchronize()
            e = err(got, want)
            del want, got
            ms, dev_t = timed2(lambda: fused.dma_gather(table, idx), 20)
            # the library call on the kernel's yardstick: device ms
            lib = lambda: torch.index_select(table, 0, idx64)  # noqa: E731
            record("dma_gather", f"n=m=2^{glogn} R={R} {kind}", e, ms,
                   dev_t, plain_ms, 2 * gn * R * 4 + 4 * gn, 0,
                   library_ms=device_time(lib, 20)[0],
                   library_wrapper_ms=timed(lib, 20))
            if (glogn, kind) == (18, "perm"):
                got = fused.dma_gather(table, idx, blk=256, nsem=4)
                torch.cuda.synchronize()
                check_only("dma_gather", f"n=m=2^{glogn} R={R} blk=256 "
                           "nsem=4", err(got, fused.dma_gather_plain(
                               table, idx)))
                ms = timed(lambda: fused.dma_gather(table, idx, blk=256,
                                                    nsem=4), 20)
                log(f"  dma_gather[blk=256 nsem=4]: kernel {ms:.4f} ms")
                del got
        del table, idx, idx64
    torch.cuda.empty_cache()

    # the front kernels. fr_slot_acc at each prove's rows (2 x 2^logn,
    # K slots a row, witness 2^logn rows, random indices), at 2^20 also
    # with a spilled row of 100 and one of 2^15 + 700 terms among rows
    # with a few, and the fixture generator's shape (3 x 2^24 rows of one
    # slot, one row of 2^24 spilled terms, the 2^24 Lagrange values
    # gathered); at 2^24 the plain version runs on the first 2^21 rows
    # (it needs ~1.6 KB a slot), a spilled row's records in parts.
    # fr_pointwise at each prove's N: cvec = a*b and h; the per-stage
    # coset multiply (3 x 2^20 by a 2^20 row), sqchain64's (3 x 128 by
    # 128), and the 2^24 split's product of the ~2^25 coefficient values
    # by one element and their difference
    plain_rows = 1 << 21       # fr_slot_acc rows; fr_pointwise 2^22 elements
    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)

    def fe_card(mod, shape):
        """fe's elements, drawn on the card (GBs of them at 2^24)."""
        w = torch.randint(0, 1 << 32, tuple(shape) + (8,), device=dev,
                          dtype=torch.int64, generator=gen)
        w[..., 7] %= mod >> 224
        return FF.to_i32(w)

    def plain_slot_acc(wit, cs, cv, spill, sub):
        """fr_slot_acc_plain over the first `sub` rows; the spilled
        records of those rows in parts of plain_rows records (the sums
        are taken mod r, so the parts add up to the whole)."""
        cs, cv = cs[:, :sub], cv[:, :sub]
        if spill is None:
            return FRONT.fr_slot_acc_plain(wit, cs, cv)
        off = spill.off[:sub + 1].long()
        total, acc = int(off[-1]), None
        for a in range(0, max(total, 1), plain_rows):
            b = min(total, a + plain_rows)
            part = FRONT.Spill(spill.s[a:b], spill.val[a:b],
                               (off - a).clamp(0, b - a).to(torch.int32),
                               None, None)
            r = FRONT.fr_slot_acc_plain(wit, cs if a == 0 else cs[:0],
                                        cv if a == 0 else cv[:0], part)
            acc = r if acc is None else FF.pack(
                FF.FR.add(FF.unpack(acc), FF.unpack(r)))
        return acc

    def slot_bytes(wit, cs, cv, spill):
        """(bytes read once and written once, the same with one 32-byte
        sector a gathered witness row, products) of a call."""
        K, rows = cs.shape
        filled = int((cv != 0).any(dim=-1).sum())
        table = filled * 36 + (rows * K - filled) * 32 + rows * 32
        nleft = 0
        if spill is not None:
            nleft = spill.s.shape[0]
            table += nleft * 36 + (rows + 1) * 4 + \
                (spill.items.numel() + spill.multi.numel()) * 4
        return (table + wit.shape[0] * 32, table + (filled + nleft) * 32,
                (filled + nleft) * MONT_IMADS)

    def slot_timing(name, key, wit, cs, cv, spill, **extra):
        """Hold fr_slot_acc against its plain version and time it; the
        recorded case. Raises at once past phase 2."""
        rows = cs.shape[1]
        got = FRONT.fr_slot_acc(wit, cs, cv, spill)
        sub = min(rows, plain_rows)
        want, plain_ms = timed_once(
            lambda: plain_slot_acc(wit, cs, cv, spill, sub))
        torch.cuda.synchronize()
        e = err(got[:sub], want)
        del want
        ms, dev_t = timed2(lambda: FRONT.fr_slot_acc(wit, cs, cv, spill),
                           10)
        nbytes, sector, imads = slot_bytes(wit, cs, cv, spill)
        record(name, key, e, ms, dev_t, plain_ms, nbytes, imads,
               plain_rows=sub,
               sector_ms=sector / HBM_BYTES_PER_S * 1e3, **extra)
        return got, ms

    def slot_case(logn, K, spill_terms=None, extra=3000, rows=None):
        rows = rows or 2 << logn
        nv = 1 << logn
        wit = fe_card(R_FR, (nv,))
        cs = torch.randint(0, nv, (K, rows), device=dev, generator=gen,
                           dtype=torch.int32)
        cv = fe_card(R_FR, (K, rows))
        spill, key = None, f"2^{logn} K={K}"
        if rows != 2 << logn:
            key = f"generator {rows // nv} x 2^{logn} rows K={K}"
        if spill_terms:
            tgt = torch.cat([
                torch.full((spill_terms,), 5, device=dev),
                torch.randint(0, rows, (extra,), device=dev, generator=gen)])
            tgt = tgt[torch.randperm(tgt.shape[0], device=dev,
                                     generator=gen)]
            spill, _ = FRONT.make_spill(
                torch.randint(0, nv, tgt.shape, device=dev, generator=gen),
                fe_card(R_FR, tgt.shape), tgt, rows)
            key += f" spill row of {spill_terms} + {extra} records"
        got, ms = slot_timing("fr_slot_acc", key, wit, cs, cv, spill)
        if spill is not None:
            # the same slots without the spilled records: the rest is theirs
            results["fr_slot_acc"]["cases"][-1]["slots_only_ms"] = timed(
                lambda: FRONT.fr_slot_acc(wit, cs, cv), 10)
        del wit, cs, cv, spill, got

    for logn, K, terms in ((LOGN_BIG, 1, None), (LOGN_BIG, 3, None),
                           (LOGN_BIG, 1, 100), (LOGN_BIG, 1, (1 << 15) + 700),
                           (LOGN_WHOLE, 1, None), (LOGN_SEG, 1, None),
                           (LOGN_SEQ, 1, None), (LOGN_MAX, 1, None),
                           (LOGN_MAX, 3, None)):
        slot_case(logn, K, terms)
        torch.cuda.empty_cache()
    # the generator's shape: A, B, C wires of one slot each, sqchain's wire
    # 0 of C spilled with a term in every constraint
    slot_case(LOGN_MAX, 1, 1 << LOGN_MAX, extra=0, rows=3 << LOGN_MAX)
    torch.cuda.empty_cache()

    pointwise_held = set()   # (op, elements, b's elements) held here

    def pointwise_case(op, ashape, bshape, tag):
        a, b = fe_card(R_FR, ashape), fe_card(R_FR, bshape)
        c = fe_card(R_FR, ashape) if op == "h" else None
        got = FRONT.fr_pointwise(op, a, b, c)
        n, nb = a.numel() // 8, b.numel() // 8
        pointwise_held.add((op, n, nb))
        # the plain version on a leading slice of a's first axis
        per = n // ashape[0]
        k = ashape[0] if n <= 2 * plain_rows else 2 * plain_rows // per
        a_, c_ = a[:k], None if c is None else c[:k]
        b_ = b[:k] if b.shape == a.shape else b
        sub = k * per
        want, plain_ms = timed_once(
            lambda: FRONT.fr_pointwise_plain(op, a_, b_, c_))
        torch.cuda.synchronize()
        e = err(got[:k], want)
        del want
        ms, dev_t = timed2(lambda: FRONT.fr_pointwise(op, a, b, c), 10)
        ins = {"mul": 1, "sub": 1, "h": 2}[op]
        record("fr_pointwise", f"{op} {tag}", e, ms, dev_t, plain_ms,
               (n * ins + nb + n) * 32,
               n * {"mul": 1, "sub": 0, "h": 2}[op] * MONT_IMADS,
               plain_rows=sub)

    for logn in (LOGN_BIG, LOGN_WHOLE, LOGN_SEG, LOGN_SEQ, LOGN_MAX):
        nn = 1 << logn
        pointwise_case("mul", (nn,), (nn,), f"2^{logn}")
        pointwise_case("h", (nn,), (nn,), f"2^{logn}")
        torch.cuda.empty_cache()
    pointwise_case("mul", (3, 1 << LOGN_BIG), (1 << LOGN_BIG,),
                   f"3 x 2^{LOGN_BIG} by a row")
    pointwise_case("mul", (3, 128), (128,), "3 x 128 by a row")
    pointwise_case("mul", (2 << LOGN_MAX,), (), f"2^{LOGN_MAX + 1} by one")
    pointwise_case("sub", (2 << LOGN_MAX,), (2 << LOGN_MAX,),
                   f"2^{LOGN_MAX + 1}")
    # the sharded front's products of the rank's 3 x N/D slice by a row of
    # N/D: the four-step's diagonal twiddle ((3, c2, N1) by (c2, N1)) and
    # the coset shift; the plain version on the first 2^22 elements of
    # the first polynomial
    for logn, nd in SHARDED:
        nloc = (1 << logn) // nd
        a, b = fe_card(R_FR, (3, nloc)), fe_card(R_FR, (nloc,))
        got = FRONT.fr_pointwise("mul", a, b)
        m = min(nloc, 2 * plain_rows)
        want, plain_ms = timed_once(
            lambda: FRONT.fr_pointwise_plain("mul", a[:1, :m], b[:m]))
        torch.cuda.synchronize()
        e = err(got[:1, :m], want)
        del got, want
        ms, dev_t = timed2(lambda: FRONT.fr_pointwise("mul", a, b), 10)
        record("fr_pointwise", f"mul 3 x 2^{nloc.bit_length() - 1} by a "
               f"row (the 2^{logn} prove's rank of {nd})", e, ms, dev_t,
               plain_ms,
               (2 * 3 * nloc + nloc) * 32, 3 * nloc * MONT_IMADS,
               plain_rows=m)
        pointwise_held.add(("mul", 3 * nloc, nloc))
        del a, b
        torch.cuda.empty_cache()
    # NTTPlan's powers_mont at 2^23 / 2^24 entries: blocks of 256 rows of
    # 4,096 by the row of the first 4,096 powers
    pointwise_case("mul", (256, 4096), (4096,),
                   "256 x 4096 by a row (powers_mont)")
    torch.cuda.empty_cache()

    # the MSM's preparation kernels. glv_digits at each prove's shapes:
    # the 2^20 and 2^21 proves' whole axis (both GLV halves of the 4 G1
    # rows and the G2 row of 2^logn scalars), a 2^22, 2^23 and 2^24 slice
    # (one half of
    # segment scalars a row, a strided view of the rows, as the segmented
    # MSM cuts them); every window at the prove's c, the edge table of
    # both groups' constants (ops/glv.edge_scalars) in front; the edge
    # table alone at c = 4, 8, 11, 13, 16 for both halves and without GLV.
    # fq_scale at its callers' shapes: phi on the 2^20 and 2^21 tables and
    # on a 2^22, 2^23 and 2^24 slice, a window group's bucket negation (a
    # strided view) at c = 13, G = 5, the window totals' map back off the
    # iso-twist, and the G2 table's rescale at 2^20-2^24.
    # Bounds: 240 IMADs a GLV half (two 8 x 5-word products, two
    # truncated 5 x 6-word ones, a low and a high IMAD a word product),
    # 264 a Montgomery product, 3 an Fq2 product.
    edge = GLVM.edge_scalars(GLVM.G1_PARAMS) + \
        GLVM.edge_scalars(GLVM.G2_PARAMS)
    edge_w = torch.from_numpy(np.array(
        [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for v in edge],
        dtype=np.uint32).view(np.int32)).to(dev)
    glv_imads = 240
    prep = {}               # (kernel, prove, curve) -> the case's key

    def digits_case(tag, sc, params, half, cc, timed_case=True):
        bits = GLV_BITS if params is not None else 256
        nw = -(-bits // cc)
        got = MSM.glv_digits(sc, cc, 0, nw, params, half)
        want, plain_ms = timed_once(
            lambda: MSM.glv_digits_plain(sc, cc, 0, nw, params, half))
        torch.cuda.synchronize()
        e = err(got, want)
        del want
        if not timed_case:
            check_only("glv_digits", tag, e)
            return
        ms, dev_t = timed2(lambda: MSM.glv_digits(sc, cc, 0, nw, params,
                                                  half), 20)
        entries = got.numel() // nw
        record("glv_digits", tag, e, ms, dev_t, plain_ms,
               sc.numel() // 8 * 32 + got.numel() * 8,
               entries * glv_imads if params is not None else 0)

    for grp, params in (("g1", GLVM.G1_PARAMS), ("g2", GLVM.G2_PARAMS)):
        esc = edge_w[None]
        for cc in (4, 8, 11, 13, 16):
            for half in (None, 0, 1):
                digits_case(f"{grp} edge table c={cc} half={half}", esc,
                            params, half, cc, timed_case=False)
    for cc in (4, 8, 11, 13, 16):
        digits_case(f"edge table c={cc} no GLV", edge_w[None], None, None,
                    cc, timed_case=False)
    held = {}                     # a case's key -> the geometry it ran
    for gk, g in geo.items():
        sliced = g["slices"] > 1
        n_ = g["width"] if sliced else g["nmax"]
        for grp, rows_, params in (("g1", 4, GLVM.G1_PARAMS),
                                   ("g2", 1, GLVM.G2_PARAMS)):
            half = (1 if grp == "g1" else 0) if sliced else None
            key = f"{grp} {rows_} x 2^{n_.bit_length() - 1} c={g['c']}" + (
                f" half {half} of a slice" if sliced else " both halves")
            prep[("glv_digits", gk, grp)] = key
            if key in held:
                continue
            held[key] = gk
            sc = fe_card(R_FR, (rows_, 2 * n_ if sliced else n_))
            sc.view(-1, 8)[:edge_w.shape[0]] = edge_w
            view = sc[:, n_:] if sliced else sc
            digits_case(key, view, params, half, g["c"])
            del sc, view
        torch.cuda.empty_cache()
    # fq_scale at its callers' shapes (tools/bench_fq_scale.cases, the
    # cases that tool times); the layouts its block split has to get
    # right (a slice ending in a ragged block, specs mixing copies,
    # negations and products, more rows than the grid's y axis holds);
    # the negations on the edge words of the canonical and relaxed range
    for key, tag, fn, plain, nbytes, products, inp in bench_fq_scale.cases(
            lambda shape, mod: fe_card(mod, shape),
            [(k, g["nmax"], (g["segment"], g["c"], g["G"]))
             for k, g in geo.items()]):
        got = fn()
        want, plain_ms = timed_once(plain)
        torch.cuda.synchronize()
        e = err(got, want)
        del got, want
        ms, dev_t = timed2(fn, 20)
        record("fq_scale", key, e, ms, dev_t, plain_ms, nbytes,
               products * MONT_IMADS,
               copy_ms=device_time(inp.clone, 20)[0])
        if tag[0] == "phi":
            for gk in tag[1]:
                prep[("fq_scale", gk, tag[2])] = key
        torch.cuda.empty_cache()
    beta1 = GLVM.params_for(G1P).beta_mont
    edge_y = torch.from_numpy(np.array(
        [[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
         for v in (0, 1, P - 1, P, 2 * P - 1, 2 * P)],
        dtype=np.uint32).view(np.int32)).to(dev)
    buckets = fe_card(P, (5, 4, 33, 3))
    buckets[0, 0, :6, 1] = edge_y
    canon = fe_card(P, (3, 5, 6))
    canon[0, :3, :] = edge_y[:3, None]
    for key, t_, spec, ext in (
            ("ragged slice 3 x 1013 of 2026", fe_card(P, (3, 2026, 4))[
                :, 1013:], (beta1, 5, None, "neg"), 1),
            ("mixed ext 1, 7 x 333", fe_card(P, (7, 333, 6)),
             (beta1, "neg", None, "neg_rx", 12345, None), 1),
            ("mixed ext 2, 5 x 77", fe_card(P, (5, 77, 6)),
             ("neg", (beta1, 77), None), 2),
            ("70000 rows of one point (a view)", fe_card(P, (70000, 2, 2))[
                :, :1], ("neg", beta1), 1),
            ("neg_rx on y in {0, 1, p-1, p, 2p-1, 2p}",
             buckets[..., :32, :, :], (None, "neg_rx", None), 1),
            ("neg and products on {0, 1, p-1}", canon,
             ("neg", (beta1, 3), None), 2)):
        got = MSM.fq_scale(t_, spec, ext)
        torch.cuda.synchronize()
        check_only("fq_scale", key, err(got, MSM.fq_scale_plain(
            t_, spec, ext)))
        del got
    del buckets, canon, edge_y
    torch.cuda.empty_cache()

    # the MSM's bucket ordering at every window-group shape the run's
    # proves give it (geo, and the committed sqchain64's and multiplier's
    # small axes): digit_sort of G x rows rows of a slice's (or a whole
    # axis's) encoded digits at the prove's c, gather_cols of the table by
    # that permutation (a view of a slice, as the segmented MSM cuts it),
    # and _ps_at's two lookups by dma_gather (the within and excl tables,
    # the boundary index padded to whole blocks); then digit_sort on the
    # edge tables at c = 4, 8, 9, 13, 16. The library calls: torch.sort
    # (stable) + searchsorted; the advanced-index gather the MSM ran
    # before (the plain version) and index_select + the move.
    # Bounds: an int64 key read, its sorted key, permutation and sign
    # written as int32 (20 B) and 4 B a boundary; a point row read and
    # written and a 4 B index an entry; dma_gather's rows and indices.
    small_geo = {}
    for fname in ("sqchain64", "multiplier"):
        zk = read_zkey(os.path.join(HERE, "tests", "fixtures",
                                    f"{fname}.zkey"))
        small_geo[fname] = plan_geo(PM.pad_len_sharded(
            max(zk.domain_size, zk.n_vars), 1))
        zk.close()
        log(f"  MSM geometry {fname}: " + json.dumps(
            {a: b for a, b in small_geo[fname].items()
             if a not in ("lanes", "adds")}))
    order_geo = {**geo, **small_geo}
    sort_held, gather_held, lookup_held = set(), set(), set()
    order = {}           # (kernel, geometry, curve) -> the case's key

    def rand_digits(shape, cc):
        """Encoded signed digits |d|*2 + (d<0), |d| <= 2^(cc-1), a
        seventh of each row padding zeros."""
        mag = torch.randint(0, (1 << (cc - 1)) + 1, shape, device=dev,
                            generator=gen)
        d = mag * 2 + torch.randint(0, 2, shape, device=dev,
                                    generator=gen) * (mag > 0)
        d[..., :shape[-1] // 7] = 0
        return d

    def kernel_names(fn):
        """The port's kernels one call of fn launches, by name, from a
        profiled call (device.traced, the events after its lead); the
        launch counts as they were."""
        saved, box = dict(D.counts), {}
        fn()
        torch.cuda.synchronize()
        with D.traced(dev, lambda p: box.update(evs=p.events())):
            fn()
            torch.cuda.synchronize()
        D.counts.update(saved)
        return Counter(m.group(1) for e in D.block_events(box["evs"])
                       for m in [re.search(r"\b(k_\w+)", e.name)] if m)

    def sort_case(key, d, cc, timed_case=True):
        got = MSM.digit_sort(d, cc)
        want, plain_ms = timed_once(lambda: MSM.digit_sort_plain(d, cc))
        torch.cuda.synchronize()
        e = max(err(a, b) for a, b in zip(got, want))
        del want
        if not timed_case:
            check_only("digit_sort", key, e)
            return got
        reps = 5 if d.numel() >= 1 << 22 else 20
        ms, dev_t = timed2(lambda: MSM.digit_sort(d, cc), reps)
        q = 2 * torch.arange((1 << (cc - 1)) + 1, device=dev) + 1
        flat = d.reshape(-1, d.shape[-1])
        qs = q.expand(flat.shape[0], q.shape[0]).contiguous()

        def lib():
            sd = torch.sort(flat, dim=-1, stable=True)[0]
            return torch.searchsorted(sd, qs, right=True)

        # the launches of a call, counted on the card: the counting pass,
        # its scan, a scatter a pass and the tail
        plan = MSM.sort_plan(cc, d.shape[-1], flat.shape[0])
        names = kernel_names(lambda: MSM.digit_sort(d, cc))
        launches = sum(v for k, v in names.items() if k.startswith("k_sort_"))
        if launches != len(plan.passes) + 3:
            failures.append(f"digit_sort[{key}] launched {dict(names)}, "
                            f"not {len(plan.passes) + 3} kernels")
        record("digit_sort", key, e, ms, dev_t, plain_ms,
               20 * d.numel() + 4 * got[3].numel(), 0,
               library_ms=device_time(lib, reps)[0],
               passes=len(plan.passes), launches_per_call=launches,
               kernels=dict(names))
        # the design's own traffic (sort_plan), on this log line only: a
        # second, looser bound than the function's 20 B a key
        design_ms = plan.traffic_bytes / HBM_BYTES_PER_S * 1e3
        log(f"  digit_sort[{key}] design traffic {plan.traffic_bytes} B "
            f"{design_ms:.4f} ms at the HBM rate, share "
            f"{design_ms / dev_t[0]:.3f} of the device ms")
        return got

    for gk, g in order_geo.items():
        n_, cc, gg = g["width"], g["c"], g["G"]
        sliced = g["slices"] > 1
        blk = MSM._ROW_GATHER_BLK
        for grp, rows_, A_, L_ in (("g1", 4, 2, 3), ("g2", 1, 4, 6)):
            skey = f"{grp} {gg} x {rows_} x {n_} c={cc}"
            gkey = f"{grp} {gg} x {rows_} x {n_} A={A_}" + (
                " a slice view" if sliced else "")
            order[("digit_sort", gk, grp)] = skey
            order[("gather_cols", gk, grp)] = gkey
            mk = -(-gg * rows_ * ((1 << (cc - 1)) + 1) // blk) * blk
            lk = ((gg * rows_ * n_, 8 * L_, mk),
                  (gg * rows_ * (n_ // 256), 8 * L_, mk))
            order[("dma_gather", gk, grp)] = f"lookup within {lk[0]}"
            if (cc, gg * rows_, n_) in sort_held:
                continue
            sort_held.add((cc, gg * rows_, n_))
            gather_held.add((A_, rows_, gg, n_))
            lookup_held.update(lk)
            d = rand_digits((gg, rows_, n_), cc)
            perm = sort_case(skey, d, cc)[1]
            del d
            tab = fe_card(P, (rows_, 2 * n_ if sliced else n_, A_))
            pts = tab[:, n_:] if sliced else tab
            got = MSM.gather_cols(pts, perm)
            want, plain_ms = timed_once(lambda: MSM.gather_cols_plain(
                pts, perm))
            torch.cuda.synchronize()
            e = err(got, want)
            del got, want
            reps = 5 if perm.numel() >= 1 << 22 else 20
            ms, dev_t = timed2(lambda: MSM.gather_cols(pts, perm), reps)
            rows64 = tab.reshape(-1, 8 * A_)
            flat = (perm + torch.arange(rows_, device=dev,
                                        dtype=torch.int32)[None, :, None]
                    * tab.shape[1] + (n_ if sliced else 0)).reshape(-1).long()
            nbk = n_ // 256

            def take_move():
                t = torch.index_select(rows64, 0, flat)
                return t.reshape(gg, rows_, nbk, 256, A_, 8).movedim(
                    3, 0).contiguous()

            plain_dev = device_time(lambda: MSM.gather_cols_plain(pts, perm),
                                    reps)[0]
            record("gather_cols", gkey, e, ms, dev_t, plain_ms,
                   perm.numel() * (64 * A_ + 4), 0, library_ms=plain_dev,
                   index_select_move_ms=device_time(take_move, reps)[0])
            del tab, pts, perm, rows64, flat
            torch.cuda.empty_cache()
            # _ps_at's lookups: tables of within's (C, G, rows, nb) and
            # excl's (G, rows, nb) points, the boundary index padded
            m0 = gg * rows_ * ((1 << (cc - 1)) + 1)
            for what, (trows, words, mpad) in zip(("within", "excl"), lk):
                table = torch.empty((trows, words), dtype=torch.int32,
                                    device=dev)
                idx = torch.randint(0, trows, (m0,), device=dev,
                                    generator=gen, dtype=torch.int64).to(
                                        torch.int32)
                padded = torch.cat([idx, idx.new_zeros(mpad - m0)])
                got = MSM._row_gather(table, idx)
                want, plain_ms = timed_once(
                    lambda: fused.dma_gather_plain(table, idx))
                torch.cuda.synchronize()
                e = err(got, want)
                del got, want

                def kern():
                    return fused.dma_gather(table, padded,
                                            blk=MSM._ROW_GATHER_BLK)

                ms, dev_t = timed2(kern, 20)
                if not torch.equal(kern()[:m0], MSM._row_gather(table, idx)):
                    failures.append(f"dma_gather lookup {what}: the padded "
                                    "launch differs from _row_gather")
                lib = lambda: torch.index_select(  # noqa: E731
                    table, 0, idx.long())
                # a table row is read once however often it is looked up
                record("dma_gather", f"lookup {what} {(trows, words, mpad)}",
                       e, ms, dev_t, plain_ms,
                       (min(trows, mpad) + mpad) * words * 4 + 4 * mpad, 0,
                       library_ms=device_time(lib, 20)[0])
                del table, idx, padded
            torch.cuda.empty_cache()
    for cc in (4, 8, 9, 13, 16):
        top = 1 << (cc + 1)
        n_tile = 3 * MSM.SORT_TILE + 256
        tiles = (torch.arange(n_tile, device=dev) // MSM.SORT_TILE * 5
                 + 1) % top
        for kind, d in (
                ("all keys 0", torch.zeros((2, 4, 4096), dtype=torch.int64,
                                           device=dev)),
                ("keys 0 and 1", torch.randint(0, 2, (2, 4, 4096),
                                               device=dev, generator=gen)),
                ("every key 2^(c+1)-1", torch.full((2, 4, 4096), top - 1,
                                                   dtype=torch.int64,
                                                   device=dev)),
                ("one row of 256", torch.randint(0, top, (1, 256),
                                                 device=dev, generator=gen)),
                ("descending keys", torch.sort(torch.randint(
                    0, top, (2, 4, 4352), device=dev, generator=gen),
                    descending=True)[0]),
                ("one key value a tile", tiles.expand(2, 4, n_tile)
                 .contiguous())):
            sort_case(f"edge {kind} c={cc} {tuple(d.shape)}", d, cc,
                      timed_case=False)
    torch.cuda.empty_cache()
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1

    # ---------------------------------------------------------- phase 3 --
    outd = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(outd, exist_ok=True)

    def verify_files(zpath, proof_p, pub_p, tag):
        with open(proof_p) as f:
            pj = json.load(f)
        with open(pub_p) as f:
            pub = json.load(f)
        pub = [] if pub is None else [int(v) for v in pub]
        proof = Proof(a=(int(pj["pi_a"][0]), int(pj["pi_a"][1])),
                      b=((int(pj["pi_b"][0][0]), int(pj["pi_b"][0][1])),
                         (int(pj["pi_b"][1][0]), int(pj["pi_b"][1][1]))),
                      c=(int(pj["pi_c"][0]), int(pj["pi_c"][1])))
        check_proof(zpath, proof, pub, tag)

    def check_proof(zpath, proof, pub, tag):
        zk = read_zkey(zpath)
        ok = verify(zkey_to_ref(zk, tables=False), proof, pub)
        zk.close()
        if not ok:
            raise RuntimeError(f"proof of {tag} does not verify")

    walls = {}               # CLI wall seconds by tag

    def prove_and_verify(zpath, wpath, tag):
        """A cold prove through the CLI entry point, pairing-verified.
        Returns (phases, peak bytes, the loaded Prover); the wall goes
        into walls[tag]."""
        proof_p = os.path.join(outd, f"{tag}_proof.json")
        pub_p = os.path.join(outd, f"{tag}_public.json")
        holder = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.run_prove(zpath, wpath, proof_p, pub_p, device="cuda",
                      prover_out=holder)
        torch.cuda.synchronize()
        wall = walls[tag] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        prover = holder[0]
        phases = dict(prover.last_phases)
        verify_files(zpath, proof_p, pub_p, tag)
        log(f"  prove {tag}: wall {wall:.3f}s phases {json.dumps(phases)} "
            f"setup {json.dumps(prover.setup_phases)} peak_mem {peak} B "
            f"verified True")
        return phases, peak, prover

    def warm_prove(prover, zpath, wpath, tag, peaks=None, rs=(None, None),
                   proof_out=None):
        """One more prove on a loaded Prover, pairing-verified; `peaks`
        (a dict) receives the device peak of each stage, and then the
        returned peak is their largest; `rs` fixes (r, s); the proof is
        appended to `proof_out` when given."""
        wt = read_wtns(wpath)
        torch.cuda.reset_peak_memory_stats()
        D.reset_counts()
        proof, pub = prover.prove(wt.values, r=rs[0], s=rs[1], peaks=peaks)
        torch.cuda.synchronize()
        need(D.counts, PROVE_KERNELS, f"the prove {tag}")
        peak = (torch.cuda.max_memory_allocated() if peaks is None
                else max(peaks.values()))
        phases = dict(prover.last_phases)
        check_proof(zpath, proof, pub, tag)
        if proof_out is not None:
            proof_out.append(proof)
        log(f"  prove {tag}: phases {json.dumps(phases)} peak_mem {peak} B "
            + ("" if peaks is None else f"stage peaks {json.dumps(peaks)} ")
            + "verified True")
        return phases, peak

    def profiled_prove(prover, zpath, wpath, want):
        """One more warm prove (the fixed (r, s)) under torch.profiler
        (device.traced: the lead's spin kernels, then the prove), CUDA
        activity, no stacks; the proof must equal `want`, and every
        wrapper the prove called must have at least as many kernels in
        the trace after the lead, on the card's timeline
        (device.block_events), as its calls launch (device.counts;
        digit_sort's passes + 3 a call, from shape_log), else the run
        fails: a trace that lost the front's first kernels is not
        reported. Returns the device kernels launched in the prove and
        in the MSMs' window (Prover.msms to its last kernel: a
        synchronize closes it), and the share of each window in which
        some kernel or copy ran on the card; the kernels taking most of
        the window's device time, the front's port kernels (before the
        MSMs' window) and digit_sort's kernels by name."""
        from torch.profiler import record_function
        wt = read_wtns(wpath)
        real_msms = prover.msms

        def msms(*a, **kw):
            with record_function("chip_smoke.msms"):
                res = real_msms(*a, **kw)
                torch.cuda.synchronize()
            return res

        box = {}
        prover.msms = msms
        try:
            with D.traced(dev, lambda p: box.update(evs=p.events())), \
                    shape_log() as seen:
                D.reset_counts()
                t0 = time.perf_counter()
                with record_function("chip_smoke.prove"):
                    proof, pub = prover.prove(wt.values, r=r_fix, s=s_fix)
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
                prove_s = t1 - t0
                calls = {k: v for k, v in D.counts.items() if v}
        finally:
            del prover.msms
        if (proof.a, proof.b, proof.c) != (want.a, want.b, want.c):
            raise RuntimeError("the profiled prove's proof differs")
        evs = box["evs"]
        cuda_t = torch.autograd.DeviceType.CUDA
        dev_evs = [e for e in D.block_events(evs)
                   if not e.name.startswith("chip_smoke.")]
        win = {e.name: (e.time_range.start, e.time_range.end) for e in evs
               if e.name.startswith("chip_smoke.")
               and e.device_type != cuda_t}

        def wrapper_of(name):
            return next((w for pre, w in PORT_KERNEL_OF
                         if name.startswith(pre)), name)

        # the kernels each wrapper's calls launch: one a count, digit_sort
        # a counting pass, its scan, a scatter a radix pass and the tail
        launched = dict(calls)
        if "digit_sort" in calls:
            if sum(seen["sort"].values()) != calls["digit_sort"]:
                raise RuntimeError(f"digit_sort: {calls['digit_sort']} "
                                   f"calls counted, {seen['sort']} seen")
            launched["digit_sort"] = sum(
                k * (len(MSM.sort_plan(c, n, rows).passes) + 3)
                for (c, rows, n), k in seen["sort"].items())
        traced = Counter(wrapper_of(m.group(1)) for e in dev_evs
                         for m in [re.search(r"\b(k_\w+)", e.name)] if m)
        lost = {k: [v, traced[k]] for k, v in launched.items()
                if traced[k] < v}

        def kernel(e):
            return not e.name.startswith(("Memcpy", "Memset"))

        def busy(lo, hi):
            spans = sorted(
                (max(e.time_range.start, lo), min(e.time_range.end, hi))
                for e in dev_evs
                if e.time_range.end > lo and e.time_range.start < hi)
            tot, cur_lo, cur_hi = 0, None, None
            for a, b in spans:
                if cur_hi is None or a > cur_hi:
                    if cur_hi is not None:
                        tot += cur_hi - cur_lo
                    cur_lo, cur_hi = a, b
                else:
                    cur_hi = max(cur_hi, b)
            if cur_hi is not None:
                tot += cur_hi - cur_lo
            return tot

        out = {"prove_s": prove_s, "device_events": len(dev_evs),
               "calls": calls, "launched_kernels": launched,
               "traced_kernels": dict(traced), "lost": lost}
        for tag, name in (("prove", "chip_smoke.prove"),
                          ("msms", "chip_smoke.msms")):
            if name not in win:
                continue
            lo, hi = win[name]
            inside = [e for e in dev_evs if lo <= e.time_range.start < hi]
            by_name = Counter()           # names cut to 80 characters
            port = Counter()              # the port's kernels, k_*
            cats = Counter()              # by wrapper; "torch" the rest
            torch_order = Counter()       # torch sorts and index gathers
            front = Counter()             # port kernels before the MSMs
            sort_n = Counter()            # digit_sort's launches by kernel
            msms_lo = win.get("chip_smoke.msms", (hi, hi))[0]
            for e in inside:
                dur = e.time_range.end - e.time_range.start
                by_name[e.name[:80]] += dur
                m = re.search(r"\b(k_\w+)", e.name)
                if m:
                    port[m.group(1)] += dur
                    cats[wrapper_of(m.group(1))] += dur
                    if e.time_range.start < msms_lo:
                        front[m.group(1)] += dur
                    if m.group(1).startswith("k_sort_"):
                        sort_n[m.group(1)] += 1
                elif kernel(e):
                    cats["torch"] += dur
                    if TORCH_ORDER.search(e.name):
                        torch_order[e.name[:80]] += dur
            out[tag] = {
                "window_ms": (hi - lo) / 1e3,
                "kernel_launches": sum(1 for e in inside if kernel(e)),
                "copies": sum(1 for e in inside if not kernel(e)),
                "busy_ms": busy(lo, hi) / 1e3,
                "busy_share": busy(lo, hi) / (hi - lo) if hi > lo else None,
                "top_kernels_ms": {k: v / 1e3
                                   for k, v in by_name.most_common(15)},
                "port_kernels_ms": {k: v / 1e3
                                    for k, v in port.most_common()},
                "categories_ms": {k: v / 1e3 for k, v in cats.most_common()},
                "front_port_kernels_ms": {k: v / 1e3
                                          for k, v in front.most_common()},
                "digit_sort_kernels_ms": {k: v / 1e3 for k, v in port.items()
                                          if k.startswith("k_sort_")},
                "digit_sort_kernel_launches": dict(sort_n),
                "torch_sort_or_gather_ms": {
                    k: v / 1e3 for k, v in torch_order.most_common()}}
        out["post_processing_s"] = time.perf_counter() - t1
        if not dev_evs:
            log("  profiler: no device activity in the trace; the idle "
                "share is not measured")
        log(f"  profiled prove: {json.dumps(out)}")
        if lost:
            raise RuntimeError("the profiled prove's trace lost kernels "
                               f"(wrapper: [launched, traced]): {lost}")
        if out.get("msms", {}).get("torch_sort_or_gather_ms"):
            raise RuntimeError("a torch sort or index gather ran in the "
                               "MSMs: "
                               f"{out['msms']['torch_sort_or_gather_ms']}")
        return out

    def front_rows(prover, wpath):
        """Prover.front alone: the MSM scalar rows, the front's own peak
        of device memory and its seconds."""
        wit = torch.from_numpy(np.ascontiguousarray(
            read_wtns(wpath).values).view(np.int32)).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows = prover.front(wit, prover.tables())
        torch.cuda.synchronize()
        return (rows, torch.cuda.max_memory_allocated(),
                time.perf_counter() - t0)

    def sha256s(*paths):
        out = {}
        for pth in paths:
            h = hashlib.sha256()
            with open(pth, "rb") as f:
                for blk in iter(lambda: f.read(1 << 24), b""):
                    h.update(blk)
            out[os.path.basename(pth)] = h.hexdigest()
        return out

    def need(counts, names, what):
        for k in names:
            if counts[k] == 0:
                raise RuntimeError(f"{what} launched no {k}")

    # From here on every prove must run the front kernels, and neither
    # Prover.front nor the fixture generator's evaluation sums may run
    # plain field arithmetic or limb (un)packing on the card: those raise
    # while either runs
    FRONT_KERNELS = ("fr_slot_acc", "fr_pointwise")
    # every prove runs the MSM's preparation kernels too
    PROVE_KERNELS = FRONT_KERNELS + ("glv_digits", "fq_scale", "digit_sort",
                                     "gather_cols", "dma_gather",
                                     "prefix_totals")
    guarded = [(FF.FieldOps, n) for n in (
        "add", "sub", "neg", "double", "canon", "add_lazy", "mul", "mul_many",
        "cond_sub_2p", "add_rx", "dadd_rx", "sub_rx", "neg_rx", "from_mont",
        "to_mont", "reduce_wide")] + [
        (FF, n) for n in ("pack", "unpack", "pack_limb_rows",
                          "unpack_limb_rows")]
    plain_fns = {(o, n): getattr(o, n) for o, n in guarded}

    def refuse_on_card(name, fn, where):
        def run(*args, **kw):
            flat = [t for a in args for t in (
                a if isinstance(a, (list, tuple)) else (a,))]
            flat = [t for a in flat for t in (
                a if isinstance(a, (list, tuple)) else (a,))]
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in flat):
                raise RuntimeError(f"plain {name} ran on a CUDA tensor "
                                   f"inside {where}")
            return fn(*args, **kw)
        return run

    def guarded(real, where):
        def run(*args, **kw):
            before = {(o, n): getattr(o, n) for o, n in plain_fns}
            for (o, n), fn in plain_fns.items():
                setattr(o, n, refuse_on_card(n, fn, where))
            try:
                return real(*args, **kw)
            finally:
                for (o, n), fn in before.items():
                    setattr(o, n, fn)
        return run

    # plain field arithmetic (FieldOps: products, sums, inversions) and
    # GLV.decompose on CUDA tensors are counted while a Prover is set up
    # and proves at 2^24 (K = 1 and 3, and on a mesh) and while the server
    # loads and answers; each such run fails unless it counted none
    @contextlib.contextmanager
    def no_plain_on_card(where):
        with plain_calls() as calls:
            yield calls
        log(f"  plain field ops / GLV.decompose on CUDA tensors during "
            f"{where}: {sum(calls.values())} {json.dumps(dict(calls))}")
        plain_on_card[where] = dict(calls)
        if calls:
            raise RuntimeError(f"{where} ran plain arithmetic on the card: "
                               f"{dict(calls)}")

    plain_on_card = {}

    Prover.front = guarded(Prover.front, "Prover.front")
    # the generator's evaluation sums, guarded, with their own device peak:
    # (the peak before them, the peak while they run) of each generator
    eval_peaks = []
    real_evaluations = guarded(fixtures._evaluations, "fixtures._evaluations")

    def evaluations_peak(*args, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = real_evaluations(*args, **kw)
        torch.cuda.synchronize()
        eval_peaks.append((before, torch.cuda.max_memory_allocated()))
        return res

    fixtures._evaluations = evaluations_peak

    def order_check(seen_, launches, what, g=None):
        """A prove's bucket ordering: digit_sort and gather_cols once per
        window group per MSM call (as often as scan_cols_packed) and
        _ps_at's two dma_gather lookups a group, each launch counted by
        its wrapper, every call at a shape phase 2 held; with geometry g,
        the very shapes and calls of its slices and window groups."""
        calls = {k: sum(seen_[k].values())
                 for k in ("sort", "gathercols", "rowgather")}
        ns = calls["sort"]
        got = {k: launches[k] for k in ("digit_sort", "gather_cols",
                                        "dma_gather", "scan_cols_packed")}
        ok = ns > 0 and calls == {"sort": ns, "gathercols": ns,
                                  "rowgather": 2 * ns} and got == {
            "digit_sort": ns, "gather_cols": ns, "dma_gather": 2 * ns,
            "scan_cols_packed": ns}
        bad = sorted((set(seen_["sort"]) - sort_held)
                     | (set(seen_["gathercols"]) - gather_held)
                     | (set(seen_["rowgather"]) - lookup_held))
        if g is not None:
            k = g["slices"] * g["groups"]
            ok = ok and seen_["sort"] == Counter(
                {(g["c"], g["G"] * r, g["width"]): k for r in (4, 1)}) \
                and seen_["gathercols"] == Counter(
                    {(a, r, g["G"], g["width"]): k
                     for a, r in ((2, 4), (4, 1))})
        if not ok or bad:
            raise RuntimeError(
                f"{what}: bucket ordering calls {calls}, launches {got}, "
                f"shapes {dict(seen_['sort'])} {dict(seen_['gathercols'])} "
                f"{dict(seen_['rowgather'])}; not held in phase 2: {bad}")
        log(f"  {what}: digit_sort and gather_cols {ns} calls and launches "
            f"each, {2 * ns} dma_gather lookups, at shapes phase 2 held")

    log("phase3: prove tests/fixtures/sqchain64")
    fx = os.path.join(HERE, "tests", "fixtures")
    D.reset_counts()
    with shape_log() as seen64:
        _, _, prover = prove_and_verify(os.path.join(fx, "sqchain64.zkey"),
                                        os.path.join(fx, "sqchain64.wtns"),
                                        "sqchain64")
    small_counts = dict(D.counts)
    log("  launches:", json.dumps(small_counts))
    order_check(seen64, small_counts, "the sqchain64 prove",
                small_geo["sqchain64"])
    need(small_counts, ("ntt_fused_pass",) + PROVE_KERNELS,
         "the sqchain64 prove")
    if small_counts["ntt_butterfly"] or small_counts["ntt_fused_pass"] != 2:
        raise RuntimeError("the sqchain64 prove's NTTs were not one fused "
                           "pass a direction")
    # its front both ways: one fused pass a direction, or RSTPU_NTT_FUSE=0
    # (14 ntt_butterfly launches, their relayouts, a coset fr_pointwise)
    wit64 = torch.from_numpy(np.ascontiguousarray(read_wtns(os.path.join(
        fx, "sqchain64.wtns")).values).view(np.int32)).to(dev)
    tables64 = prover.tables()
    rows64 = prover.front(wit64, tables64)
    os.environ["RSTPU_NTT_FUSE"] = "0"
    try:
        same = torch.equal(prover.front(wit64, tables64), rows64)
    finally:
        del os.environ["RSTPU_NTT_FUSE"]
    if not same:
        raise RuntimeError("sqchain64's per-layer front rows differ")
    front64 = both_ways(lambda: prover.front(wit64, tables64), 50)
    prover.release()
    log(f"  sqchain64 front: CLI prove {prover.last_phases['front']:.4f} s; "
        f"fused {front64['fused']:.4f} ms, per layer "
        f"{front64['per_layer']:.4f} ms a call (50 calls, rows equal)")
    small_ntt["sqchain64 front"] = {**front64,
                                    "cli_s": prover.last_phases["front"]}

    # the multiplier with record 0 split into k random parts (a row that
    # spills past its K slots; past 2^15 terms the JAX package's pass is
    # two-level): the proof equals ref/groth16.prove's for a fixed (r, s)
    r_fix, s_fix = 1122334455, 9988776655
    mzk = read_zkey(os.path.join(fx, "multiplier.zkey"))
    mwt = read_wtns(os.path.join(fx, "multiplier.wtns"))
    prng = random.Random(91)
    dense = {}
    for k in (100, (1 << 15) + 700):
        orig = words_to_ints(mzk.coef_val[:1])[0]
        parts = [prng.randrange(R_FR) for _ in range(k - 1)]
        parts.append((orig - sum(parts)) % R_FR)
        counts = np.ones(mzk.n_coefs, np.int64)
        counts[0] = k
        vals = np.concatenate([np.stack([np.frombuffer(
            v.to_bytes(32, "little"), "<u4") for v in parts]),
            mzk.coef_val[1:]])
        dz = fixtures.split_coefs(mzk, counts, vals)
        D.reset_counts()
        dp = Prover(dz, device="cuda")
        t0 = time.perf_counter()
        with shape_log() as seen_m:
            proof, pub = dp.prove(mwt.values, r=r_fix, s=s_fix)
        dt = time.perf_counter() - t0
        dcounts = dict(D.counts)
        need(dcounts, PROVE_KERNELS, f"the multiplier prove with {k} parts")
        order_check(seen_m, dcounts, f"the multiplier prove with {k} parts",
                    small_geo["multiplier"])
        ref_zk = zkey_to_ref(dz)
        want = ref_prove(ref_zk, words_to_ints(mwt.values), r=r_fix, s=s_fix)
        if (proof.a, proof.b, proof.c) != (want.a, want.b, want.c):
            raise RuntimeError(f"the multiplier proof with a row of {k} "
                               "terms differs from ref/groth16.prove")
        if not verify(ref_zk, proof, pub):
            raise RuntimeError(f"the multiplier proof with a row of {k} "
                               "terms does not verify")
        if dp.left_s is None or (dp.acc2_seg is None) != (k < 1 << 15):
            raise RuntimeError(f"the multiplier with {k} parts did not "
                               "spill as expected")
        dense[k] = {"coef_slots": dp.coef_slots,
                    "spilled": int(dp.left_s.shape[0]), "prove_s": dt,
                    "launches": dcounts}
        log(f"  multiplier, record 0 in {k} parts: K {dp.coef_slots}, "
            f"{dense[k]['spilled']} spilled records, prove {dt:.3f}s, "
            f"equals ref/groth16.prove, verified True; launches "
            f"{json.dumps(dcounts)}")
        dp.release()
    mzk.close()

    def affine_all(pts, g2):
        """Packed projective points (rows, L, 8) on the card -> the host's
        affine points."""
        w = pts.cpu().numpy().view(np.uint32)
        H, conv = (G2H, host_g2) if g2 else (G1H, host_g1)
        return [H.to_affine(conv(w[b])) for b in range(w.shape[0])]

    def phase4_options(prover, zpath, wpath, rows):
        """On the loaded 2^20 Prover: the device window combine against
        the host combine of Prover.prove, msm(glv=False) against
        msm(glv=True) on 2^16 points, and the sequential-NTT front
        against the stacked one."""
        tables = prover.tables()
        c, nwin = prover.c_bits, -(-GLV_BITS // prover.c_bits)
        g1w, g2w = prover.msms(rows, tables)
        torch.cuda.synchronize()
        out = {}
        for tag, curve, wpts, H, conv in (("g1", G1P, g1w, G1H, host_g1),
                                          ("g2", G2P, g2w, G2H, host_g2)):
            D.reset_counts()
            t0 = time.perf_counter()
            tot = MSM._combine_windows(curve, wpts, nwin, c)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            adds = D.counts["add"]
            th = time.perf_counter()
            w = wpts.cpu().numpy().view(np.uint32)
            host = [H.to_affine(H.combine_windows(
                [conv(w[i, b]) for i in range(nwin)], c))
                for b in range(w.shape[1])]
            host_dt = time.perf_counter() - th
            if affine_all(tot, curve is G2P) != host:
                raise RuntimeError(f"device combine of the {tag} window "
                                   "totals differs from the host combine")
            if adds != (nwin - 1) * (c + 1):
                raise RuntimeError(f"the {tag} combine launched {adds} adds")
            log(f"  combine {tag}: {w.shape[1]} rows equal the host combine; "
                f"{adds} add launches {dt:.4f}s on the card, host combine "
                f"{host_dt:.4f}s")
            out[f"combine_{tag}"] = {"add_launches": adds, "device_s": dt,
                                     "host_s": host_dt}
        npt = 1 << 16
        g1_sc = torch.stack([rows[0], rows[1], rows[1], rows[2]])
        for tag, curve, pts, sc in (
                ("g1", G1P, tables["pts_g1"][:, :npt], g1_sc[:, :npt]),
                ("g2", G2P, tables["pts_g2"][:, :npt], rows[1][None, :npt])):
            res = {}
            for glv in (True, False):
                D.reset_counts()
                t0 = time.perf_counter()
                tot = MSM.msm(curve, pts, sc.contiguous(), c,
                              prover.window_group, combine=True, glv=glv)
                torch.cuda.synchronize()
                res[glv] = (affine_all(tot, curve is G2P),
                            time.perf_counter() - t0, dict(D.counts))
            if res[True][0] != res[False][0]:
                raise RuntimeError(f"msm(glv=False) on {tag} differs from "
                                   "msm(glv=True)")
            log(f"  msm {tag} 2^16 points combine=True: glv=False equals "
                f"glv=True; glv {res[True][1]:.4f}s scans "
                f"{res[True][2]['scan_cols_packed']}, no glv "
                f"{res[False][1]:.4f}s scans "
                f"{res[False][2]['scan_cols_packed']}")
            out[f"msm_2^16_{tag}"] = {"glv_s": res[True][1],
                                      "no_glv_s": res[False][1]}
        os.environ["RSTPU_NTT_SEQ"] = "1"
        try:
            zk = read_zkey(zpath)
            seq = Prover(zk, device="cuda")
            zk.close()
        finally:
            del os.environ["RSTPU_NTT_SEQ"]
        if not seq.ntt_seq or prover.ntt_seq:
            raise RuntimeError("RSTPU_NTT_SEQ=1 did not reach the Prover")
        front_rows(seq, wpath)                               # warm-up
        rows_seq, seq_peak, seq_s = front_rows(seq, wpath)
        _, front_peak2, front_s2 = front_rows(prover, wpath)
        seq.release()
        if not torch.equal(rows_seq, rows):
            raise RuntimeError("sequential-NTT front rows differ from the "
                               "stacked ones")
        log(f"  RSTPU_NTT_SEQ=1 front rows equal the stacked ones; front "
            f"peak {seq_peak} B in {seq_s:.4f}s, stacked {front_peak2} B in "
            f"{front_s2:.4f}s")
        out["ntt_sequential"] = {
            "front_peak_mem_bytes": seq_peak, "front_s": seq_s,
            "stacked_front_peak_mem_bytes": front_peak2,
            "stacked_front_s": front_s2}
        return out

    # the shapes the kernels run at while a prove runs (shape_log); phase
    # 2 must have timed them
    seen = {}

    def logged_prove(*args):
        with shape_log() as now:
            seen.clear()
            seen.update(now)
            return prove_and_verify(*args)

    def check_widths(run, times):
        for curve, tag in ((G1P, "g1"), (G2P_ISO, "g2")):
            want = Counter({n: k * times
                            for n, k in add_launches[curve][run].items()})
            got = Counter({n: k for (g1, n), k in seen["add"].items()
                           if g1 == (curve is G1P)})
            if got != want:
                raise RuntimeError(f"{run} x {times}: {tag} add widths "
                                   f"{dict(got)}, phase 2 timed "
                                   f"{dict(want)}")
        log(f"  add widths and launches as phase 2 timed them ({run} x "
            f"{times})")

    def prep_launches(counts, slices, groups, what, cold=True):
        """A prove, cold (the Prover's set-up rescales the G2 table: one
        fq_scale) or warm: two MSM calls (G1, G2) of `slices` slices each:
        glv_digits once a slice; fq_scale once a phi slice (half of them,
        or the whole axis), once a window group of a slice (the bucket
        negation) and once for the G2 totals' map back off the
        iso-twist."""
        phis = slices // 2 if slices > 1 else 1
        want = {"glv_digits": 2 * slices,
                "fq_scale": cold + 2 * phis + 2 * slices * groups + 1}
        got = {k: counts[k] for k in want}
        if got != want:
            raise RuntimeError(f"{what} launched {got}, not {want}")
        log(f"  preparation kernels' launches as expected: {got}")

    def check_geo(prover, gk, counts, cold=True, passes=True):
        """A prove (cold: with the Prover's set-up) ran geometry geo[gk]
        (nmax, segment, c, G), every scan, add and (with `passes`) fused
        NTT pass at a shape phase 2 held, and the preparation kernels'
        launches that geometry makes. Returns (slices, window groups)."""
        g = geo[gk]
        nwin = -(-GLV_BITS // prover.c_bits)
        ran = (prover.nmax, prover.segment, prover.c_bits,
               MSM.group_size(nwin, prover.window_group))
        log(f"  {gk}: nmax {prover.nmax} segment {prover.segment} c_bits "
            f"{prover.c_bits} G {ran[3]} slices {g['slices']} window "
            f"groups {g['groups']} ntt_sequential {prover.ntt_seq} "
            f"launches {json.dumps(counts)}")
        if ran != (g["nmax"], g["segment"], g["c"], g["G"]):
            raise RuntimeError(
                f"the {gk} prove ran (nmax, segment, c, G) {ran}; phase 2 "
                f"held the kernels for "
                f"{(g['nmax'], g['segment'], g['c'], g['G'])}")
        slices, groups = g["slices"], g["groups"]
        check_widths(gk, slices)
        want = Counter({(g1, 256, g["lanes"][cv]): slices * groups
                        for g1, cv in ((True, G1P), (False, G2P_ISO))})
        if seen["scan"] != want or counts["scan_cols_packed"] != \
                2 * slices * groups:
            raise RuntimeError(f"scans ran at {dict(seen['scan'])}, phase 2 "
                               f"checked {dict(want)}")
        nb = g["width"] // 256
        want = Counter({(True, 4 * g["G"], nb): slices * groups,
                        (False, g["G"], nb): slices * groups})
        if seen["prefix"] != want or counts["prefix_totals"] != \
                4 * slices * groups:
            raise RuntimeError(f"prefix_totals ran at {dict(seen['prefix'])}"
                               f" ({counts['prefix_totals']} launches), "
                               f"phase 2 held {dict(want)}, 2 launches a "
                               "call")
        if passes and (set(seen["pass"]) - ntt_checked or not seen["pass"]
                       or sum(seen["pass"].values())
                       != counts["ntt_fused_pass"]):
            raise RuntimeError(f"fused NTT passes ran at "
                               f"{dict(seen['pass'])}, phase 2 checked "
                               f"{sorted(ntt_checked)}")
        log(f"  scans{' and fused NTT passes' if passes else ''} at the "
            f"shapes phase 2 checked: "
            f"{json.dumps([list(k) + [v] for k, v in seen['pass'].items()])}")
        prep_launches(counts, slices, groups, f"the {gk} prove", cold)
        order_check(seen, counts, f"the {gk} prove", g)
        need(counts, ("add", "scan_cols_packed", "ntt_fused_pass")
             + PROVE_KERNELS, f"the {gk} prove")
        return slices, groups

    def check_rank(line, seen_, logn, nd):
        """A rank of a sharded prove of 2^logn points over nd ranks ran
        the geometry phase 2 held for its axis and the ranks sharing the
        card, the cross-rank sums at the widths phase 2 timed, the four-step's
        transforms as fused passes phase 2 held and its row products
        (twice the diagonal twiddle, once the coset shift) at a shape
        phase 2 held."""
        g = geo[f"2^{logn} D={nd}" if nd > 1 else f"2^{logn}"]
        p1 = (logn + 1) // 2
        n2 = 1 << (logn - p1)
        four = {"n1": 1 << p1, "n2": n2, "c2": n2 // nd,
                "local_domain": (1 << logn) // nd}
        sl = g["slices"]
        ran = (line["size"], line["nmax"], line["segment"], line["c_bits"],
               line["slices"], line["four_step"])
        want_ = (nd, g["nmax"] * nd, g["segment"], g["c"], sl, four)
        if ran != want_:
            raise RuntimeError(
                f"a rank of 2^{logn} over {nd} ran (ranks, nmax, segment, "
                f"c, slices, four-step) {ran}; phase 2 held {want_}")
        nw = -(-GLV_BITS // g["c"])
        for curve, rows, is_g1 in ((G1P, 4, True), (G2P_ISO, 1, False)):
            want = Counter({n: k * sl for n, k in g["adds"][curve].items()})
            if nd > 1:
                want[nw * rows * nd] += (nd - 1).bit_length()
            got = Counter({n: k for (g1, n), k in seen_["add"].items()
                           if g1 == is_g1})
            if got != want:
                raise RuntimeError(f"a rank's adds ran at {dict(got)}, "
                                   f"phase 2 timed {dict(want)}")
        want = Counter({(g1, 256, g["lanes"][cv]): sl * g["groups"]
                        for g1, cv in ((True, G1P), (False, G2P_ISO))})
        if seen_["scan"] != want:
            raise RuntimeError(f"a rank's scans ran at {dict(seen_['scan'])}"
                               f", phase 2 held {dict(want)}")
        if set(seen_["pass"]) - ntt_checked or not seen_["pass"] or \
                sum(seen_["pass"].values()) != \
                line["launches"]["ntt_fused_pass"]:
            raise RuntimeError(f"a rank's fused NTT passes ran at "
                               f"{dict(seen_['pass'])}, phase 2 held "
                               f"{sorted(ntt_checked)}")
        order_check(seen_, line["launches"], f"a rank of 2^{logn} over {nd}",
                    g)
        row = ("mul", 3 * four["local_domain"], four["local_domain"])
        if seen_["pointwise"][row] != 3 or row not in pointwise_held:
            raise RuntimeError(f"a rank's row products ran at "
                               f"{dict(seen_['pointwise'])}; phase 2 held "
                               f"{sorted(pointwise_held)}")

    def sharded_ranks(nd, backend, zpath, wpath, tag, limit=900.0):
        """nd processes of this script (--rank) proving zpath as the ranks
        of one job over `backend`, (r_fix, s_fix); their JSON lines in
        rank order and the wall seconds. Every process is stopped on the
        way out; a rank that fails fails the phase."""
        od = os.path.join(outd, tag)
        os.makedirs(od, exist_ok=True)
        coord = f"127.0.0.1:{free_port()}"
        files, procs = [], []
        t0 = time.perf_counter()
        try:
            for i in range(nd):
                files.append((open(os.path.join(od, f"rank{i}.out"), "w"),
                              open(os.path.join(od, f"rank{i}.err"), "w")))
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank",
                     str(nd), str(i), coord, backend, zpath, wpath, od,
                     str(r_fix), str(s_fix)],
                    cwd=HERE, stdout=files[-1][0], stderr=files[-1][1]))
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or \
                        time.perf_counter() - t0 > limit:
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for fo, fe_ in files:
                fo.close()
                fe_.close()
        wall = time.perf_counter() - t0
        lines = []
        for i, p in enumerate(procs):
            with open(os.path.join(od, f"rank{i}.err")) as f:
                err_tail = f.read()[-3000:]
            if p.returncode != 0:
                raise RuntimeError(f"{tag}: rank {i} exited {p.returncode}:"
                                   f"\n{err_tail}")
            with open(os.path.join(od, f"rank{i}.out")) as f:
                lines.append(json.loads(f.read().strip().splitlines()[-1]))
        return lines, wall

    # ---------------------------------------------------------- phase 4 --
    log(f"phase4: generate sqchain{1 << LOGN_BIG} on the card")
    fixdir = os.path.join(HERE, "bench_fixtures")
    t0 = time.perf_counter()
    zpath, wpath = fixtures.generate(LOGN_BIG, fixdir, device="cuda")
    gen_s = time.perf_counter() - t0
    log(f"  generated in {gen_s:.1f}s sha256 "
        f"{json.dumps(sha256s(zpath, wpath))}")
    D.reset_counts()
    cold, peak, prover = logged_prove(zpath, wpath, "big_cold")
    big_counts = dict(D.counts)
    log("  launches:", json.dumps(big_counts))
    # (phase 2 times the 2^20 prove's main passes, not each of them)
    check_geo(prover, f"2^{LOGN_BIG}", big_counts, passes=False)
    warm, peak2 = warm_prove(prover, zpath, wpath, "big_warm")
    rows_fused, front_peak, _ = front_rows(prover, wpath)
    extras = phase4_options(prover, zpath, wpath, rows_fused)
    prover.release()
    log(json.dumps({f"prove_2^{LOGN_BIG}": {
        "cold": cold, "warm": warm, "setup": prover.setup_phases,
        "peak_mem_bytes": max(peak, peak2),
        "front_peak_mem_bytes": front_peak, "fixture_gen_s": gen_s,
        "segment": prover.segment, "c_bits": prover.c_bits, **extras,
        "card": card}}))

    # ---------------------------------------------------------- phase 5 --
    log(f"phase5: the 2^{LOGN_BIG} prove with per-stage NTTs "
        "(RSTPU_NTT_FUSE=0)")
    os.environ["RSTPU_NTT_FUSE"] = "0"
    try:
        D.reset_counts()
        ps_cold, ps_peak, prover = prove_and_verify(zpath, wpath,
                                                    "per_stage_cold")
        stage_counts = dict(D.counts)
        log("  launches:", json.dumps(stage_counts))
        need(stage_counts, ("ntt_tail", "ntt_butterfly") + PROVE_KERNELS,
             "the per-stage prove")
        if stage_counts["ntt_fused_pass"]:
            raise RuntimeError("the per-stage prove ran fused passes")
        ps_warm, _ = warm_prove(prover, zpath, wpath, "per_stage_warm")
        rows_stage, _, _ = front_rows(prover, wpath)
    finally:
        del os.environ["RSTPU_NTT_FUSE"]
    prover.release()
    if not torch.equal(rows_stage, rows_fused):
        raise RuntimeError("per-stage front rows differ from the fused ones")
    log("  per-stage front rows equal the fused configuration's")
    log(json.dumps({f"prove_2^{LOGN_BIG}_per_stage_ntt": {
        "cold": ps_cold, "warm": ps_warm, "peak_mem_bytes": ps_peak,
        "card": card}}))
    del rows_stage, rows_fused
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 6 --
    tools_logn = LOGN_BIG + 1
    log(f"phase6: the gather tools at 2^{tools_logn} rows of 64 bytes")
    D.reset_counts()
    tool_gather = bench_gather.main([str(tools_logn), "4", "8"],
                                    device="cuda")
    tool_dma = bench_dma_gather.main([str(tools_logn), "16"], device="cuda")
    tool_counts = dict(D.counts)
    log("  launches:", json.dumps(tool_counts))
    if not (tool_gather["correct"] and tool_dma["correct"]):
        raise RuntimeError("a gather tool reports a wrong result")
    need(tool_counts, ("dma_gather",), "the gather tools")
    log(json.dumps({"gather_tools": {"bench_gather": tool_gather,
                                     "bench_dma_gather": tool_dma,
                                     "card": card}}))
    # the MSM's measurement tools at the 2^24 and the 2^22 slice shapes:
    # one window group's stages (G1 on 4 rows, G2 on 1 row of a slice's
    # entries), the ablation of 4 G1 rows of 2 x segment points (four
    # slices of the prove's shape) with its gather formulations, and a
    # sweep of c there on G1 (4 rows) and G2
    msm_tools = {}
    tool_shapes = {}
    for lg in (LOGN_MAX, LOGN_SEG):
        g = geo[f"2^{lg}"]
        tool_shapes.setdefault((g["width"], g["c"], g["G"]), lg)
    for (width, c_, g_), lg in tool_shapes.items():
        sl = width.bit_length() - 1
        cc, gg, seg_ = str(c_), str(g_), str(width)
        sweep_cs = ",".join(str(k) for k in (c_ - 1, c_, c_ + 1) if k <= 16)
        log(f"phase6: the MSM tools at the 2^{lg} slice shape "
            f"(2^{sl} entries)")
        D.reset_counts()
        t0 = time.perf_counter()
        stages = {cv: bench_msm_phases.main(
            [str(sl), cc, gg, "3", cv, "4" if cv == "g1" else "1"],
            device="cuda") for cv in ("g1", "g2")}
        ablate = msm_ablate.main([str(sl + 1), "2", seg_, cc, "4", gg],
                                 device="cuda")
        sweep = sweep_msm.main(["both", str(sl + 1), sweep_cs, seg_, "2",
                                "4", gg], device="cuda")
        tcounts = dict(D.counts)
        if not (all(v["digits_equal_plain"] for v in stages.values())
                and ablate["gather_equal"]):
            raise RuntimeError(f"an MSM tool at the 2^{lg} slice reports a "
                               "wrong result")
        need(tcounts, ("glv_digits", "fq_scale", "scan_cols_packed", "add",
                       "dma_gather"), f"the MSM tools at the 2^{lg} slice")
        msm_tools[f"2^{lg} slice"] = {
            "bench_msm_phases": stages, "msm_ablate": ablate,
            "sweep_msm": sweep, "launches": tcounts,
            "seconds": time.perf_counter() - t0}
        torch.cuda.empty_cache()
    log(json.dumps({"msm_tools": msm_tools, "card": card}))

    # ---------------------------------------------------------- phase 7 --
    log("phase7: the proof server over HTTP")
    os.chdir(HERE)                  # the server's build_dir is ./build
    big_name = f"sqchain{1 << LOGN_BIG}"
    small_z = os.path.join(fx, "sqchain64.zkey")
    os.makedirs("build", exist_ok=True)
    for name, steps in ((big_name, (1 << LOGN_BIG) - 2), ("sqchain64", 64)):
        # witness generators as the server runs them:
        # ./build/<circuit> <input.json> <circuit.wtns>
        exe = os.path.join("build", name)
        with open(exe, "w") as f:
            f.write(f"#!{sys.executable}\n"
                    "import json, sys\n"
                    f"sys.path.insert(0, {HERE!r})\n"
                    "from rapidsnark_tpu_torch.io.wtns import write_wtns\n"
                    "from rapidsnark_tpu_torch.ref.setup import "
                    "sqchain_witness\n"
                    "with open(sys.argv[1]) as f:\n"
                    "    x0 = int(json.load(f)['x0'])\n"
                    f"write_wtns(sys.argv[2], sqchain_witness({steps}, x0))\n")
        os.chmod(exe, 0o755)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    started = []                    # the (FullProver, HTTPServer) of serve()
    make_server = server_http.make_server

    def capture(fp, *a, **kw):
        srv = make_server(fp, *a, **kw)
        started.append((fp, srv))
        return srv

    server_http.make_server = capture
    server_guard = contextlib.ExitStack()
    server_guard.enter_context(no_plain_on_card(
        "the server's registry load and requests"))
    t_load = time.perf_counter()
    srv_thread = threading.Thread(
        target=server_main, args=([str(port), zpath, small_z],), daemon=True)
    srv_thread.start()

    def http(method, path, body=None):
        req = urllib.request.Request(base + path, data=body, method=method)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def status():
        code, body = http("GET", "/status")
        if code != 200:
            raise RuntimeError(f"GET /status answered {code}")
        return json.loads(body)

    polls_loading = 0
    while True:                      # 200 while the registry loads
        if not srv_thread.is_alive():
            raise RuntimeError("the server thread ended while loading")
        try:
            st = status()
        except (ConnectionError, urllib.error.URLError):
            if time.perf_counter() - t_load > 60:
                raise
            time.sleep(0.01)         # the listener is not up yet
            continue
        if st == {"status": "ready"}:
            break
        if st != {}:
            raise RuntimeError(f"status while loading: {st}")
        polls_loading += 1
        if time.perf_counter() - t_load > 300:
            raise RuntimeError("the registry did not load in 300 s")
        time.sleep(0.05)
    load_s = time.perf_counter() - t_load
    server_http.make_server = make_server
    full_prover, http_server = started[0]
    log(f"  registry of 2 circuits ready in {load_s:.3f}s "
        f"({polls_loading} polls answered 200 with {{}} meanwhile)")
    if polls_loading == 0:
        raise RuntimeError("no /status poll was answered during the load")

    def wait_done(t0, limit=300.0):
        while True:
            st = status()
            if st.get("status") != "busy":
                return st, time.perf_counter() - t0
            if time.perf_counter() - t0 > limit:
                raise RuntimeError("the server stayed busy")
            time.sleep(0.01)

    def request(circuit, body):
        t0 = time.perf_counter()
        code, _ = http("POST", f"/input/{circuit}", body)
        if code != 200:
            raise RuntimeError(f"POST /input/{circuit} answered {code}")
        return t0

    def proved(circuit, zkey_path, x0, tag):
        """One request to its end: success, both fields JSON strings,
        the proof pairing-verified against the payload's publics."""
        t0 = request(circuit, json.dumps({"x0": x0}).encode())
        st, dt = wait_done(t0)
        if st.get("status") != "success":
            raise RuntimeError(f"{tag}: {st}")
        if not (isinstance(st["proof"], str)
                and isinstance(st["pubData"], str)):
            raise RuntimeError(f"{tag}: proof / pubData are not strings")
        pj, pub = json.loads(st["proof"]), json.loads(st["pubData"])
        proof = Proof(a=(int(pj["pi_a"][0]), int(pj["pi_a"][1])),
                      b=((int(pj["pi_b"][0][0]), int(pj["pi_b"][0][1])),
                         (int(pj["pi_b"][1][0]), int(pj["pi_b"][1][1]))),
                      c=(int(pj["pi_c"][0]), int(pj["pi_c"][1])))
        check_proof(zkey_path, proof, [int(v) for v in pub], tag)
        total = full_prover.provers[circuit].last_phases["total"]
        log(f"  {tag}: POST to success {dt:.3f}s, prove "
            f"{total:.3f}s (last_phases), pubData {st['pubData'][:70]} "
            f"verified True")
        return {"post_to_success_s": dt, "prove_total_s": total,
                "phases": dict(full_prover.provers[circuit].last_phases)}, pub

    D.reset_counts()
    req_first, pub3 = proved(big_name, zpath, 3, "request 2^20 x0=3")
    server_counts = dict(D.counts)
    log("  launches:", json.dumps(server_counts))
    need(server_counts, ("add", "scan_cols_packed", "ntt_fused_pass")
         + PROVE_KERNELS, "the first 2^20 request")
    D.reset_counts()
    req_warm, pub5 = proved(big_name, zpath, 5, "request 2^20 x0=5")
    need(D.counts, PROVE_KERNELS, "the second 2^20 request")
    if pub5 == pub3:
        raise RuntimeError("the second request returned the first's publics")
    D.reset_counts()
    req_small, _ = proved("sqchain64", small_z, 3, "request sqchain64")
    server_small_counts = dict(D.counts)
    need(server_small_counts, ("ntt_fused_pass",) + PROVE_KERNELS,
         "the sqchain64 request")
    if server_small_counts["ntt_butterfly"]:
        raise RuntimeError("the sqchain64 request launched ntt_butterfly")
    small_ntt["sqchain64 request front_s"] = req_small["phases"]["front"]
    code, _ = http("POST", "/input/nosuch", b"{}")
    if code != 404:
        raise RuntimeError(f"POST /input/nosuch answered {code}, not 404")
    # a request followed at once by a second one: the first is aborted
    # before its prove starts (or finishes unseen), the second one's
    # publics are what the status ends with
    request(big_name, json.dumps({"x0": 7}).encode())
    t0 = request(big_name, json.dumps({"x0": 5}).encode())
    while True:                      # through aborted / the first's success
        st, dt = wait_done(t0)
        if st.get("status") == "success" and \
                json.loads(st["pubData"]) == pub5:
            break
        if st.get("status") not in ("aborted", "success"):
            raise RuntimeError(f"overwritten request ended {st}")
        if time.perf_counter() - t0 > 300:
            raise RuntimeError("the second request never finished")
        time.sleep(0.01)
    log(f"  overwrite: two requests at once ended with the second one's "
        f"pubData after {dt:.3f}s")
    t0 = request(big_name, b"this is not JSON")
    st, _ = wait_done(t0)
    if st.get("status") != "failed" or not isinstance(st.get("error"), str) \
            or not st["error"]:
        raise RuntimeError(f"a body that is not JSON ended {st}")
    log(f"  not JSON: failed with error {st['error']!r}")
    http_server.shutdown()
    srv_thread.join(30)
    http_server.server_close()
    if srv_thread.is_alive():
        raise RuntimeError("the server thread did not stop")
    server_guard.close()
    for loaded in full_prover.provers.values():
        loaded.release()
    del full_prover, started
    torch.cuda.empty_cache()
    log(json.dumps({"server": {
        "registry_load_s": load_s, "first_2^20": req_first,
        "warm_2^20": req_warm, "sqchain64": req_small, "card": card}}))

    # ---------------------------------------------------------- phase 8 --
    def prove_size(logn, tag, gk, extra=0, proof_out=None):
        """Generate the 2^logn sqchain on the card (with `extra` wires,
        the wide variant), prove it through the CLI entry point (cold)
        and on the loaded Prover (warm, fixed (r, s), the device peak of
        each stage; the proof appended to `proof_out` when given), each
        proof pairing-verified and the prove's geometry and kernel shapes
        geo[gk]'s, as phase 2 held them. Returns its JSON entry and the
        zkey and wtns paths."""
        D.reset_counts()
        parts = {}
        t0 = time.perf_counter()
        zp, wp = fixtures.generate(logn, fixdir, device="cuda", parts=parts,
                                   extra=extra)
        gen_s = time.perf_counter() - t0
        gcounts = dict(D.counts)
        log(f"  generated {os.path.basename(zp)} in {gen_s:.1f}s parts "
            f"{json.dumps(parts)} evaluations' device peak "
            f"{eval_peaks[-1][1]} B launches {json.dumps(gcounts)} sizes "
            f"{os.path.getsize(zp)} / {os.path.getsize(wp)} B")
        need(gcounts, ("add_mixed_packed", "add_mixed") + FRONT_KERNELS,
             f"the {tag} fixture generator")
        torch.cuda.empty_cache()
        D.reset_counts()
        cold, peak, prover = logged_prove(zp, wp, f"{tag}_cold")
        counts = dict(D.counts)
        log(f"  {tag} Prover: n_vars {prover.n_vars} domain {prover.domain} "
            f"nmax {prover.nmax} segment {prover.segment} c "
            f"{prover.c_bits}")
        slices, groups = check_geo(prover, gk, counts)
        peaks, proofs = {}, []
        warm, _ = warm_prove(prover, zp, wp, f"{tag}_warm", peaks=peaks,
                             rs=(r_fix, s_fix), proof_out=proofs)
        if proof_out is not None:
            proof_out += proofs
        out = {"cold": cold, "warm": warm, "cli_wall_s": walls[f"{tag}_cold"],
               "setup": dict(prover.setup_phases),
               "peak_mem_bytes": {"cli_cold": peak, **{
                   f"warm_{k}": v for k, v in peaks.items()}},
               "fixture_gen_s": gen_s, "fixture_gen_parts": parts,
               "n_vars": prover.n_vars, "domain": prover.domain,
               "nmax": prover.nmax, "segment": prover.segment,
               "c_bits": prover.c_bits, "slices": slices,
               "window_groups": groups, "ntt_sequential": prover.ntt_seq,
               "launches": counts, "generator_launches": gcounts,
               "card": card}
        prover.release()
        torch.cuda.empty_cache()
        return out, zp, wp

    log(f"phase8: generate sqchain{1 << LOGN_WHOLE} on the card (the "
        "whole-axis MSM, a 1-bit top NTT pass)")
    whole_out, _, _ = prove_size(LOGN_WHOLE, "whole", f"2^{LOGN_WHOLE}")
    log(json.dumps({f"prove_2^{LOGN_WHOLE}": whole_out}))

    log(f"phase8: generate sqchain{1 << LOGN_SEG} on the card")
    seg_proof = []
    seg_out, zpath, wpath = prove_size(LOGN_SEG, "seg", f"2^{LOGN_SEG}",
                                       proof_out=seg_proof)
    gen_counts, seg_counts = seg_out["generator_launches"], seg_out["launches"]
    # the kernels' share of the segmented MSMs, from this run's times at
    # the slice's shapes: one G1 and one G2 scan per slice per group
    scan_s = seg_out["slices"] * seg_out["window_groups"] * 1e-3 * sum(
        next(cs["ms"] for cs in results["scan_cols_packed"]["cases"]
             if cs["case"] ==
             f"{tag} K=256 n={geo[f'2^{LOGN_SEG}']['lanes'][cv]}")
        for tag, cv in (("g1", G1P), ("g2", G2P_ISO)))
    seg_out.update(msms_scan_kernel_s=scan_s,
                   msms_other_s=seg_out["warm"]["msms"] - scan_s)
    log(json.dumps({f"prove_2^{LOGN_SEG}": seg_out}))

    # ------------------------------------------------- phase 8, sharded --
    log(f"phase8 sharded: sqchain{1 << LOGN_SEG} on D ranks as processes "
        "sharing this card (backend gloo: every exchange through host "
        "memory; these times are not scaling numbers)")
    want_json = seg_proof[0].to_json_dict()
    shard_note = ("the ranks share one card and gloo moves every exchange "
                  "through host memory: not a scaling number")
    sharded = {}
    rank_counts = {}
    shard_runs = [(nd, "gloo") for lg, nd in SHARDED if lg == LOGN_SEG]
    if torch.cuda.device_count() >= 2:
        # one card a rank over NCCL; a machine with one card skips this
        shard_runs.append((2, "nccl"))
    torch.cuda.empty_cache()
    for nd, backend in shard_runs:
        tag = f"2^{LOGN_SEG} D={nd} {backend}"
        lines, wall = sharded_ranks(nd, backend, zpath, wpath,
                                    f"sharded_{nd}_{backend}")
        briefs = []
        for ln in lines:
            if ln["proof"] != want_json:
                raise RuntimeError(f"{tag}: rank {ln['rank']}'s proof "
                                   "differs from the single-card proof")
            if (ln["backend"], ln["size"]) != (backend, nd):
                raise RuntimeError(f"{tag}: rank {ln['rank']} ran "
                                   f"{ln['backend']} x {ln['size']}")
            plain_on_card[f"{tag} rank {ln['rank']}"] = ln["plain_on_card"]
            if ln["plain_on_card"]:
                raise RuntimeError(f"{tag}: rank {ln['rank']} ran plain "
                                   f"arithmetic on the card: "
                                   f"{ln['plain_on_card']}")
            seen_ = {k: Counter({tuple(e[:-1]): e[-1] for e in v})
                     for k, v in ln["seen"].items()}
            check_rank(ln, seen_, LOGN_SEG, nd)
            brief = {k: v for k, v in ln.items() if k not in ("proof",
                                                              "seen")}
            briefs.append(brief)
            log(json.dumps({"run": tag, "rank_line": brief,
                            "note": shard_note if backend == "gloo" else
                            None, "card": card}))
        rank_counts[tag] = lines[0]["launches"]
        sharded[tag] = {"wall_s": wall, "ranks": briefs,
                        "proof_equals_single_card": True}
        log(f"  {tag}: {nd} ranks proved the single-card proof's bytes in "
            f"{wall:.1f}s wall, kernel shapes as phase 2 held them, no "
            f"plain field op on the card")

    # ------------------------------------------- phase 8, wide and 2^23 --
    log(f"phase8 wide: sqchainw{1 << LOGN_SEG} on the card ({WIDE_EXTRA} "
        "more wires than the domain: the Prover pads its axis to whole "
        "segments)")
    wide_out, zp, wp = prove_size(LOGN_SEG, "wide", "wide",
                                  extra=WIDE_EXTRA)
    for f in (zp, wp):
        os.remove(f)
    log(json.dumps({f"prove_2^{LOGN_SEG}_wide": wide_out}))
    log(f"phase8: generate sqchain{1 << LOGN_SEQ} on the card (the plan's "
        "slices, sequential NTTs with a 3-bit top pass)")
    seq_out, _, _ = prove_size(LOGN_SEQ, "seq", f"2^{LOGN_SEQ}")
    log(json.dumps({f"prove_2^{LOGN_SEQ}": seq_out}))

    # ---------------------------------------------------------- phase 9 --
    name = f"sqchain{1 << LOGN_MAX}"
    log(f"phase9: generate {name} on the card")
    if os.path.isdir(fixdir):
        for f in os.listdir(fixdir):
            if f.startswith("sqchain") and not f.startswith(name + "."):
                os.remove(os.path.join(fixdir, f))
    os.makedirs(fixdir, exist_ok=True)
    host = {"machine_before": machine(fixdir), "rss_before": rss_now()}
    log("  machine:", json.dumps(host["machine_before"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    D.reset_counts()
    parts = {}
    t0 = time.perf_counter()
    with RssPeak() as gen_rss:
        zpath, wpath = fixtures.generate(LOGN_MAX, fixdir, device="cuda",
                                         parts=parts)
    gen_s = time.perf_counter() - t0
    max_gen_counts = dict(D.counts)
    host["generator_rss_peak"] = gen_rss.peak
    # the peak before the evaluation sums, and the peak from them on
    gen_peak = max(eval_peaks[-1][0], torch.cuda.max_memory_allocated())
    log(f"  generated in {gen_s:.1f}s parts {json.dumps(parts)} "
        f"device peak {gen_peak} B (evaluations {eval_peaks[-1][1]} B) "
        f"rss peak {gen_rss.peak} B"
        f" launches {json.dumps(max_gen_counts)} sizes "
        f"{os.path.getsize(zpath)} / {os.path.getsize(wpath)} B")
    need(max_gen_counts, ("add_mixed_packed", "add_mixed") + FRONT_KERNELS,
         f"the 2^{LOGN_MAX} fixture generator")
    torch.cuda.empty_cache()
    # the device peak of each Prover's set-up (binning on the card)
    setup_peaks = []
    real_init = Prover.__init__

    def peaked_init(self, *a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        real_init(self, *a, **kw)
        torch.cuda.synchronize()
        setup_peaks.append(torch.cuda.max_memory_allocated())

    Prover.__init__ = peaked_init
    D.reset_counts()
    with RssPeak() as cli_rss, no_plain_on_card(
            f"the 2^{LOGN_MAX} CLI prove (the Prover's set-up included)"):
        cold, cold_peak, prover = logged_prove(zpath, wpath, "max_cold")
    max_counts = dict(D.counts)
    host["cli_rss_peak"] = cli_rss.peak
    host["machine_after"] = machine(fixdir)
    slices, groups = check_geo(prover, f"2^{LOGN_MAX}", max_counts)
    peaks, k1_proof = {}, []
    with no_plain_on_card(f"the warm 2^{LOGN_MAX} prove"):
        warm, _ = warm_prove(prover, zpath, wpath, "max_warm", peaks=peaks,
                             rs=(r_fix, s_fix), proof_out=k1_proof)
    profile = profiled_prove(prover, zpath, wpath, k1_proof[0])
    if "msms" in profile:
        # the profiler's host cost stretches its window: the device's
        # kernel time against the unprofiled warm prove's MSMs too
        profile["msms"]["busy_over_unprofiled_msms"] = \
            profile["msms"]["busy_ms"] / 1e3 / warm["msms"]
        log(f"  MSMs' device time {profile['msms']['busy_ms']:.1f} ms of "
            f"the unprofiled warm MSMs' {warm['msms'] * 1e3:.1f} ms")
    setup = dict(prover.setup_phases)
    k1_coef_bytes = (prover.coef_s.numel() * prover.coef_s.element_size()
                     + prover.coef_val.numel() * 4)

    def prover_slots(prover, tag):
        """fr_slot_acc on the Prover's own coefficient tables and witness
        (near-sequential wires), held and timed beside phase 2's
        random-index case at the same K."""
        wit = torch.from_numpy(np.ascontiguousarray(
            read_wtns(wpath).values).view(np.int32)).to(dev)
        K = prover.coef_slots
        random_ms = next(c["ms"] for c in results["fr_slot_acc"]["cases"]
                         if c["case"] == f"2^{LOGN_MAX} K={K}")
        n_fail = len(failures)
        _, ms = slot_timing("fr_slot_acc", f"2^{LOGN_MAX} K={K} {tag}", wit,
                            prover.coef_s, prover.coef_val, prover.spill,
                            random_index_ms=random_ms)
        if len(failures) > n_fail:
            raise RuntimeError(failures[-1])
        return ms

    slots_k1_ms = prover_slots(prover, "prover tables")
    k1 = (prover.coef_slots, prover.left_s is None)
    out = {
        "cold": cold, "warm": warm, "cli_wall_s": walls["max_cold"],
        "setup": setup, "generator_s": gen_s, "generator_parts": parts,
        "peak_mem_bytes": {"generator": gen_peak,
                           "generator_evaluations": eval_peaks[-1][1],
                           "setup": setup_peaks[-1], "cli_cold": cold_peak,
                           **{f"warm_{k}": v for k, v in peaks.items()}},
        "card_mem_bytes": torch.cuda.get_device_properties(0).total_memory,
        "launches": max_counts, "generator_launches": max_gen_counts,
        "nmax": prover.nmax, "segment": prover.segment,
        "c_bits": prover.c_bits, "window_group": geo[f"2^{LOGN_MAX}"]["G"],
        "slices": slices, "window_groups": groups,
        "ntt_sequential": prover.ntt_seq, "host": host,
        "profile_warm": profile, "card": card}

    prover.release()
    del prover
    torch.cuda.empty_cache()

    # the same circuit, every coefficient record v split into v c1, v c2
    # and v (1 - c1 - c2) (Montgomery words, by fr_pointwise on the card):
    # K = 3 slots a row, the same proof for the same (r, s)
    log(f"  {name} with every coefficient record in three parts")
    t0 = time.perf_counter()
    zk = read_zkey(zpath)
    D.reset_counts()
    zk3 = fixtures.split_thirds(zk, dev)
    split_counts = {k: D.counts[k] for k in FRONT_KERNELS}
    split_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    k3_guard = contextlib.ExitStack()
    k3_guard.enter_context(no_plain_on_card(
        f"the 2^{LOGN_MAX} K = 3 Prover's set-up and proves"))
    prover = Prover(zk3, device="cuda")
    Prover.__init__ = real_init
    zk.close()
    del zk, zk3
    if (prover.coef_slots, prover.left_s is None) != (3, True) or \
            k1 != (1, True):
        raise RuntimeError(f"the split zkey binned to K = "
                           f"{prover.coef_slots} (spilled "
                           f"{prover.left_s is not None}); the original to "
                           f"{k1}")
    k3_coef_bytes = (prover.coef_s.numel() * prover.coef_s.element_size()
                     + prover.coef_val.numel() * 4)
    k3_first, k3_proofs = {}, []
    first, _ = warm_prove(prover, zpath, wpath, "max_k3_first",
                          peaks=k3_first, rs=(r_fix, s_fix),
                          proof_out=k3_proofs)
    k3_peaks = {}
    k3_warm, _ = warm_prove(prover, zpath, wpath, "max_k3_warm",
                            peaks=k3_peaks, rs=(r_fix, s_fix),
                            proof_out=k3_proofs)
    k3_counts = dict(D.counts)
    k3_guard.close()
    slots_k3_ms = prover_slots(prover, "prover tables")
    pa, pb = k1_proof[0], k3_proofs[-1]
    if (pa.a, pa.b, pa.c) != (pb.a, pb.b, pb.c):
        raise RuntimeError("the K = 3 proof differs from the K = 1 proof")
    # the plan leaves half of the card to a second circuit's tables
    for tag, pk in (("K = 1", peaks), ("K = 3", k3_peaks)):
        if max(pk.values()) > PEAK_LIMIT:
            raise RuntimeError(f"the warm 2^{LOGN_MAX} prove at {tag} "
                               f"peaked at {max(pk.values())} B, over "
                               f"{PEAK_LIMIT} B: {pk}")
    allowed = peaks["front"] + (k3_coef_bytes - k1_coef_bytes) + (1 << 30)
    if k3_peaks["front"] > allowed:
        raise RuntimeError(f"the K = 3 front peaked at {k3_peaks['front']} "
                           f"B, over the K = 1 front's {peaks['front']} B "
                           f"+ the larger tables + 1 GiB = {allowed} B")
    log(f"  K = 3 (coef_slots {prover.coef_slots}): split {split_s:.1f}s, "
        f"set-up {json.dumps(prover.setup_phases)} device peak "
        f"{setup_peaks[-1]} B (K = 1: {setup_peaks[0]} B), coefficient "
        f"tables "
        f"{k3_coef_bytes} B (K = 1: {k1_coef_bytes} B); front peak "
        f"{k3_peaks['front']} B (K = 1: {peaks['front']} B, allowed "
        f"{allowed} B); the proof equals the K = 1 proof, verified True")
    out["k3"] = {"coef_slots": prover.coef_slots, "split_s": split_s,
                 "split_launches": split_counts,
                 "setup": dict(prover.setup_phases),
                 "setup_peak_bytes": setup_peaks[-1], "first": first,
                 "warm": k3_warm, "first_peaks": k3_first,
                 "warm_peaks": k3_peaks, "coef_table_bytes": k3_coef_bytes,
                 "k1_coef_table_bytes": k1_coef_bytes, "launches": k3_counts,
                 "front_peak_allowed": allowed}
    out["fr_slot_acc_prover_tables_ms"] = {"K=1": slots_k1_ms,
                                           "K=3": slots_k3_ms}
    out["plain_on_card"] = plain_on_card
    prover.release()
    del prover
    torch.cuda.empty_cache()
    log(json.dumps({f"prove_2^{LOGN_MAX}": out}))

    # ------------------------------------------------- phase 9, sharded --
    log(f"phase9 sharded: {name} on a one-rank NCCL mesh in this process "
        "(four-step NTTs, the sharded MSMs), then through the CLI with "
        "RSTPU_COORD / RSTPU_NPROCS=1 / RSTPU_PROC_ID=0")
    torch.cuda.empty_cache()
    MH.initialize(coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
                  process_id=0, backend="nccl", device="cuda")
    try:
        mesh = MH.global_mesh("cuda")
        mesh_peaks = {}
        with no_plain_on_card(f"the one-rank NCCL 2^{LOGN_MAX} Prover's "
                              "set-up and prove"), shape_log() as seen1:
            torch.cuda.reset_peak_memory_stats()
            zk = read_zkey(zpath)
            sp = Prover(zk, mesh=mesh)
            zk.close()
            torch.cuda.synchronize()
            mesh_setup_peak = torch.cuda.max_memory_allocated()
            D.reset_counts()
            proof, _ = sp.prove(read_wtns(wpath).values, r=r_fix, s=s_fix,
                                peaks=mesh_peaks)
            torch.cuda.synchronize()
            nccl_counts = dict(D.counts)
        pa = k1_proof[0]
        if (proof.a, proof.b, proof.c) != (pa.a, pa.b, pa.c):
            raise RuntimeError("the one-rank NCCL 2^24 proof differs from "
                               "phase 9's warm proof")
        need(nccl_counts, ("add", "scan_cols_packed", "ntt_fused_pass")
             + PROVE_KERNELS, "the one-rank NCCL prove")
        line = {**dist_prove_worker.rank_summary(sp),
                "launches": nccl_counts}
        check_rank(line, seen1, LOGN_MAX, 1)
        mesh_out = {**line, "setup": dict(sp.setup_phases),
                    "setup_peak_bytes": mesh_setup_peak,
                    "stage_peaks": mesh_peaks,
                    "proof_equals_phase9_warm": True}
        log(f"  one-rank NCCL: the proof equals phase 9's warm proof; "
            f"phases {json.dumps(sp.last_phases)} stage peaks "
            f"{json.dumps(mesh_peaks)} set-up peak {mesh_setup_peak} B")
        sp.release()
        del sp
    finally:
        MH.shutdown()
    torch.cuda.empty_cache()
    rank_counts[f"2^{LOGN_MAX} one-rank NCCL"] = nccl_counts
    proof_p = os.path.join(outd, "cli_env_knobs_proof.json")
    pub_p = os.path.join(outd, "cli_env_knobs_public.json")
    env = {**os.environ, "RSTPU_COORD": f"127.0.0.1:{free_port()}",
           "RSTPU_NPROCS": "1", "RSTPU_PROC_ID": "0"}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "rapidsnark_tpu_torch.cli",
                          zpath, wpath, proof_p, pub_p], cwd=HERE, env=env,
                         capture_output=True, text=True, timeout=900)
    cli_mesh_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"the env-knob CLI exited {res.returncode}: "
                           f"{res.stderr[-3000:]}")
    verify_files(zpath, proof_p, pub_p, "the env-knob CLI")
    log(f"  the CLI with RSTPU_COORD / RSTPU_NPROCS=1 / RSTPU_PROC_ID=0: "
        f"{cli_mesh_s:.1f}s wall, the proof pairing-verifies")
    sharded[f"2^{LOGN_MAX} one-rank NCCL"] = mesh_out
    sharded["cli_env_knobs_wall_s"] = cli_mesh_s
    log(json.dumps({"sharded": sharded, "card": card}))

    # --------------------------------------------------------- phase 10 --
    # per kernel: source, the TPU kernel it replaces, the counts of the
    # run whose path it is on, and the checked case at that path's shape
    # (the generator runs add_mixed_packed on G1 and add_mixed on G2)
    meta = {
        "add": ("csrc/curve.cu", "rapidsnark_tpu/ops/fused.py:159",
                big_counts, "g1"),
        "scan_cols_packed": ("csrc/curve.cu",
                             "rapidsnark_tpu/ops/fused.py:176", big_counts,
                             "g1"),
        "ntt_fused_pass": ("csrc/ntt.cu", "rapidsnark_tpu/ops/fused.py:371",
                           big_counts, f"2^{LOGN_BIG} bits 0+10 dit"),
        "ntt_butterfly": ("csrc/ntt.cu", "rapidsnark_tpu/ops/fused.py:233",
                          stage_counts, f"n={3 << (LOGN_BIG - 1)} dit"),
        "ntt_tail": ("csrc/ntt.cu", "rapidsnark_tpu/ops/fused.py:458",
                     stage_counts, "dif"),
        "add_mixed_packed": ("csrc/curve.cu",
                             "rapidsnark_tpu/ops/fused.py:219", gen_counts,
                             "g1"),
        "add_mixed": ("csrc/curve.cu", "rapidsnark_tpu/ops/fused.py:170",
                      gen_counts, "g2"),
        "dma_gather": ("csrc/gather.cu", "tools/bench_dma_gather.py:32",
                       big_counts, order[("dma_gather", f"2^{LOGN_BIG}",
                                          "g1")]),
        "fr_slot_acc": ("csrc/front.cu", "rapidsnark_tpu/prover.py:578",
                        big_counts, f"2^{LOGN_BIG} K=1"),
        "fr_pointwise": ("csrc/front.cu", "rapidsnark_tpu/prover.py:686",
                         big_counts, f"h 2^{LOGN_BIG}"),
        "glv_digits": ("csrc/msm.cu", "rapidsnark_tpu/ops/glv.py:230",
                       big_counts,
                       prep[("glv_digits", f"2^{LOGN_BIG}", "g1")]),
        "fq_scale": ("csrc/msm.cu", "rapidsnark_tpu/ops/msm.py:535",
                     big_counts, prep[("fq_scale", f"2^{LOGN_BIG}", "g1")]),
        "digit_sort": ("csrc/sort.cu", "rapidsnark_tpu/ops/msm.py:482",
                       big_counts, order[("digit_sort", f"2^{LOGN_BIG}",
                                          "g1")]),
        "gather_cols": ("csrc/gather.cu", "rapidsnark_tpu/ops/msm.py:117",
                        big_counts, order[("gather_cols", f"2^{LOGN_BIG}",
                                           "g1")]),
    }
    runs = {"sqchain64": small_counts, f"2^{LOGN_BIG}": big_counts,
            f"2^{LOGN_BIG} per-stage": stage_counts,
            "gather tools": tool_counts,
            f"server 2^{LOGN_BIG} request": server_counts,
            "server sqchain64 request": server_small_counts,
            f"2^{LOGN_WHOLE} generator": whole_out["generator_launches"],
            f"2^{LOGN_WHOLE}": whole_out["launches"],
            f"2^{LOGN_SEG} generator": gen_counts,
            f"2^{LOGN_SEG}": seg_counts,
            f"2^{LOGN_SEG} wide": wide_out["launches"],
            f"2^{LOGN_SEQ} generator": seq_out["generator_launches"],
            f"2^{LOGN_SEQ}": seq_out["launches"],
            f"2^{LOGN_MAX} generator": max_gen_counts,
            f"2^{LOGN_MAX}": max_counts,
            f"2^{LOGN_MAX} K=3 warm": out["k3"]["launches"],
            **{f"multiplier {k} parts": v["launches"]
               for k, v in dense.items()},
            **{f"{k} rank 0" if "D=" in k else k: v
               for k, v in rank_counts.items()}}
    log(json.dumps({"small_ntt_ms": small_ntt, "card": card}))
    kernels = []
    for name, (src, rep, counts, pick) in meta.items():
        ent = results[name]
        main_case = next(c for c in ent["cases"] if pick in c["case"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "rapidsnark_tpu_torch/" + src, "replaces": rep,
            "launches": counts[name], "max_abs_err": ent["max_abs_err"],
            "ms": main_case["ms"], "device_ms": main_case["device_ms"],
            "device_method": main_case["device_method"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "launches_by_run": {k: v[name] for k, v in runs.items()},
            "cases": ent["cases"]})
    log(json.dumps({"run_s": time.perf_counter() - t_run, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--rank"]
             else main())
