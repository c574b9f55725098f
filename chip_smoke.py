#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (rapidsnark_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (sm_90a: H100) and nvcc; exits non-zero without
them, or when run away from the repository. Phases, in order; any
failure exits non-zero:
  1. the card's name and power limit, torch / CUDA versions, and the
     build of every kernel (all nvcc processes started together);
  2. each of the seven kernels against its plain PyTorch version on the
     same inputs on the card (exact words; G1 outputs of the relaxed law
     compared mod p; ntt_tail also against ntt_fused_pass on bits 0-6),
     and each timed with CUDA events beside the plain version and the
     least time the card could take (bound), at every shape the proves
     below give it: the whole-axis 2^20 prove's, and the segmented 2^22
     prove's (a slice's scan, the narrow cross-slice add, every fused
     pass over 3 x 2^22);
  3. prove the committed tests/fixtures/sqchain64 through the CLI entry
     point and pairing-verify (the small circuit's NTTs run
     ntt_butterfly);
  4. generate bench_fixtures/sqchain1048576.{zkey,wtns} on the card and
     prove it through the CLI entry point (cold), then once more on the
     loaded Prover (warm); the proof must pairing-verify, and add /
     scan_cols_packed / ntt_fused_pass must each have launched during
     the first prove;
  5. the per-stage NTT configuration (RSTPU_NTT_FUSE=0) on the same
     2^20 fixture through the CLI entry point: the proof pairing-
     verifies, ntt_tail and ntt_butterfly both launched, and
     Prover.front gives the fused configuration's rows word for word;
  6. generate bench_fixtures/sqchain4194304.{zkey,wtns} on the card
     (add_mixed_packed and add_mixed must have launched), prove it
     through the CLI entry point with the segmented MSM (cold), then on
     the loaded Prover (warm); the proof must pairing-verify and
     scan_cols_packed must have launched once per slice per window group
     per MSM call;
  7. a `kernels` JSON line, the card line, and the result line last.

Bounds: bytes over 3.35 TB/s (each input read once, each output written
once) against 32-bit multiply-adds over the SMs' IMAD rate, 132 SMs x 64
per clock x 1.98 GHz = 16.7e12/s (H100 SXM; Hopper white paper). A
Montgomery product of 8 x 8 32-bit limbs is counted as 264 IMADs (two
64-product passes, a low and a high IMAD each, plus the 8 quotient
digits); additions are not counted.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
MONT_IMADS = 264
LOGN_BIG = 20
LOGN_SEG = 22       # the segmented prove
GEN_LANES = 1 << 18  # scalars per fixed-base ladder chunk (fixtures._CH)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes, imads):
    tb = nbytes / HBM_BYTES_PER_S
    to = imads / IMAD_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


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
    from rapidsnark_tpu_torch.ops.ntt import _passes
    from rapidsnark_tpu_torch.ops.curve import G1P, G2P, G2P_ISO
    from rapidsnark_tpu_torch.ops.glv import GLV_BITS
    from rapidsnark_tpu_torch.ref.field import P, R_FR
    from rapidsnark_tpu_torch.ref.groth16 import Proof, verify

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
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{src}]: {line.strip()}")

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

    def record(name, key, e, ms, plain_ms, nbytes, imads):
        b, by = bound_ms(nbytes, imads)
        ent = results.setdefault(name, {"max_abs_err": 0, "cases": []})
        ent["max_abs_err"] = max(ent["max_abs_err"], e)
        ent["cases"].append({"case": key, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": b, "bound_by": by})
        log(f"  {name}[{key}]: err {e} kernel {ms:.4f} ms plain "
            f"{plain_ms} ms bound {b:.4f} ms ({by})")
        if e != 0:
            failures.append(f"{name}[{key}] disagrees (max err {e})")

    def check_only(name, key, e):
        ent = results.setdefault(name, {"max_abs_err": 0, "cases": []})
        ent["max_abs_err"] = max(ent["max_abs_err"], e)
        log(f"  {name}[{key}]: err {e}")
        if e != 0:
            failures.append(f"{name}[{key}] disagrees (max err {e})")

    # main-path shapes of the 2^20 prove: c = 13, G = 5, GLV 2^21 entries
    G, c = 5, 13
    M = 1 << (c - 1)
    nb = (2 << LOGN_BIG) // 256
    lanes = {G1P: G * 4 * nb, G2P_ISO: G * 1 * nb}
    add_lanes = {G1P: G * 4 * (M + 1), G2P_ISO: G * 1 * (M + 1)}
    # the segmented 2^22 prove (phase 6 fails unless it ran with these):
    # a slice's scan has segment / 256 lanes per window per table row, and
    # the cross-slice accumulate adds one point per window per row
    seg = config.msm_segment(1 << LOGN_SEG)
    seg_c = MSM.best_window_bits(1 << LOGN_SEG, seg)
    seg_nwin = -(-GLV_BITS // seg_c)
    seg_G = max(g for g in range(1, config.window_group() + 1)
                if seg_nwin % g == 0)
    if not seg or (1 << LOGN_SEG) % seg:
        raise RuntimeError(f"2^{LOGN_SEG} points do not segment ({seg})")
    seg_lanes = {G1P: seg_G * 4 * (seg // 256), G2P_ISO: seg_G * (seg // 256)}
    seg_add_lanes = {G1P: seg_G * 4, G2P_ISO: seg_G}
    coords = {G1P: 3, G2P_ISO: 6, G2P: 6}
    mont_add = {G1P: 17, G2P_ISO: 36}
    mont_mixed = {G1P: 14, G2P_ISO: 33}

    log("phase2: kernels vs plain versions")
    for curve, tag in ((G1P, "g1"), (G2P_ISO, "g2")):
        L = coords[curve]
        # add: a small adversarial-free random batch, then the main shape
        for n in (1000, add_lanes[curve], seg_add_lanes[curve]):
            p, q = fe(P, (n, L)), fe(P, (n, L))
            want, plain_ms = timed_once(lambda: fused.add_plain(curve, p, q))
            got = fused.add(curve, p, q)
            torch.cuda.synchronize()
            e = err_mod(curve, got, want)
            if n == 1000:
                check_only("add", f"{tag} n={n}", e)
                continue
            ms = timed(lambda: fused.add(curve, p, q),
                       20 if n == add_lanes[curve] else 200)
            record("add", f"{tag} n={n}", e, ms, plain_ms,
                   3 * n * L * 32, n * mont_add[curve] * MONT_IMADS)
        # scan_cols_packed: K in {1, 2, 256}, signs set, some infinities
        A = L - L // 3
        for K, n in ((1, 1000), (2, 1000), (256, 1000),
                     (256, lanes[curve]), (256, seg_lanes[curve])):
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
            ms = timed(lambda: fused.scan_cols_packed(curve, acc, cols,
                                                      sign), 3)
            record("scan_cols_packed", f"{tag} K={K} n={n}", e, ms,
                   plain_ms,
                   n * L * 32 + K * n * (A * 32 + 4 + L * 32),
                   K * n * mont_mixed[curve] * MONT_IMADS)
            del acc, cols, sign
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
            for name, kern, plain, qq, qbytes in (
                    ("add_mixed_packed", fused.add_mixed_packed,
                     fused.add_mixed_packed_plain, q, A * 32),
                    ("add_mixed", fused.add_mixed, fused.add_mixed_plain,
                     to_limbs(q), A * 64)):
                want, plain_ms = timed_once(lambda: plain(curve, p, qq))
                got = kern(curve, p, qq)
                torch.cuda.synchronize()
                e = err(got, want)
                if n == 1000:
                    check_only(name, f"{tag} n={n}", e)
                    continue
                ms = timed(lambda: kern(curve, p, qq), 20)
                record(name, f"{tag} n={n}", e, ms, plain_ms,
                       n * (2 * L * 32 + qbytes),
                       n * mont_strict[curve] * MONT_IMADS)
        torch.cuda.empty_cache()

    # NTT kernels: Fr elements. The fused passes of the 2^20 prove, then
    # every pass of the 2^22 prove's two transforms (DIF top-down, DIT
    # bottom-up with the coset pre-multiply on its first pass)
    def pass_cases(logn, cases):
        n = 1 << logn
        x, tw, pm = fe(R_FR, (3, n)), fe(R_FR, (n // 2,)), fe(R_FR, (n,))
        for lo, k, dif, pre in cases:
            pmul = pm if pre else None
            key = f"3 x 2^{logn} bits {lo}+{k} " \
                f"{'dif' if dif else 'dit'}" + (" pre_mul" if pre else "")
            want, plain_ms = timed_once(lambda: fused.ntt_fused_pass_plain(
                x, tw, lo, k, dif, pmul))
            got = fused.ntt_fused_pass(x, tw, lo, k, dif, pmul)
            torch.cuda.synchronize()
            e = err(got, want)
            del want, got
            ms = timed(lambda: fused.ntt_fused_pass(x, tw, lo, k, dif,
                                                    pmul), 10)
            elems = 3 * n
            nbytes = 2 * elems * 32 + (1 << (lo + k - 1)) * 32 + \
                (n * 32 if pre else 0)
            imads = (elems // 2 * k + (elems if pre else 0)) * MONT_IMADS
            record("ntt_fused_pass", key, e, ms, plain_ms, nbytes, imads)
        return x, tw

    seg_passes = _passes(LOGN_SEG)
    x, tw = pass_cases(LOGN_SEG,
                       [(lo, k, True, False) for lo, k in seg_passes] +
                       [(lo, k, False, lo == 0) for lo, k in seg_passes])
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
        ms = timed(lambda: fused.ntt_tail(x, tw, dif), 10)
        record("ntt_tail", key, err(got, want), ms, plain_ms,
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
            ms = timed(lambda: fused.ntt_butterfly(lo_, hi_, tw_, dif),
                       50 if n == 3 * 64 else 10)
            record("ntt_butterfly", tag, e, ms, plain_ms, 5 * n * 32,
                   n * MONT_IMADS)
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

    def prove_and_verify(zpath, wpath, tag):
        """A cold prove through the CLI entry point, pairing-verified.
        Returns (phases, peak bytes, the loaded Prover)."""
        proof_p = os.path.join(outd, f"{tag}_proof.json")
        pub_p = os.path.join(outd, f"{tag}_public.json")
        holder = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.run_prove(zpath, wpath, proof_p, pub_p, device="cuda",
                      prover_out=holder)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        prover = holder[0]
        phases = dict(prover.last_phases)
        verify_files(zpath, proof_p, pub_p, tag)
        log(f"  prove {tag}: wall {wall:.3f}s phases {json.dumps(phases)} "
            f"setup {json.dumps(prover.setup_phases)} peak_mem {peak} B "
            f"verified True")
        return phases, peak, prover

    def warm_prove(prover, zpath, wpath, tag):
        """One more prove on a loaded Prover, pairing-verified."""
        wt = read_wtns(wpath)
        torch.cuda.reset_peak_memory_stats()
        proof, pub = prover.prove(wt.values)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        phases = dict(prover.last_phases)
        check_proof(zpath, proof, pub, tag)
        log(f"  prove {tag}: phases {json.dumps(phases)} peak_mem {peak} B "
            f"verified True")
        return phases, peak

    def front_rows(prover, wpath):
        """Prover.front alone: the MSM scalar rows and the front's own
        peak of device memory."""
        wit = torch.from_numpy(np.ascontiguousarray(
            read_wtns(wpath).values).view(np.int32)).to(dev)
        torch.cuda.reset_peak_memory_stats()
        rows = prover.front(wit, prover.tables())
        torch.cuda.synchronize()
        return rows, torch.cuda.max_memory_allocated()

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

    log("phase3: prove tests/fixtures/sqchain64")
    fx = os.path.join(HERE, "tests", "fixtures")
    D.reset_counts()
    _, _, prover = prove_and_verify(os.path.join(fx, "sqchain64.zkey"),
                                    os.path.join(fx, "sqchain64.wtns"),
                                    "sqchain64")
    small_counts = dict(D.counts)
    prover.release()
    log("  launches:", json.dumps(small_counts))
    need(small_counts, ("ntt_butterfly",), "the sqchain64 prove")

    # ---------------------------------------------------------- phase 4 --
    log(f"phase4: generate sqchain{1 << LOGN_BIG} on the card")
    fixdir = os.path.join(HERE, "bench_fixtures")
    t0 = time.perf_counter()
    zpath, wpath = fixtures.generate(LOGN_BIG, fixdir, device="cuda")
    gen_s = time.perf_counter() - t0
    log(f"  generated in {gen_s:.1f}s sha256 "
        f"{json.dumps(sha256s(zpath, wpath))}")
    D.reset_counts()
    cold, peak, prover = prove_and_verify(zpath, wpath, "big_cold")
    big_counts = dict(D.counts)
    log("  launches:", json.dumps(big_counts))
    need(big_counts, ("add", "scan_cols_packed", "ntt_fused_pass"),
         f"the 2^{LOGN_BIG} prove")
    warm, peak2 = warm_prove(prover, zpath, wpath, "big_warm")
    rows_fused, front_peak = front_rows(prover, wpath)
    prover.release()
    log(json.dumps({f"prove_2^{LOGN_BIG}": {
        "cold": cold, "warm": warm, "setup": prover.setup_phases,
        "peak_mem_bytes": max(peak, peak2),
        "front_peak_mem_bytes": front_peak, "fixture_gen_s": gen_s,
        "segment": prover.segment, "c_bits": prover.c_bits, "card": card}}))

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
        need(stage_counts, ("ntt_tail", "ntt_butterfly"),
             "the per-stage prove")
        if stage_counts["ntt_fused_pass"]:
            raise RuntimeError("the per-stage prove ran fused passes")
        ps_warm, _ = warm_prove(prover, zpath, wpath, "per_stage_warm")
        rows_stage, _ = front_rows(prover, wpath)
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
    log(f"phase6: generate sqchain{1 << LOGN_SEG} on the card")
    D.reset_counts()
    t0 = time.perf_counter()
    zpath, wpath = fixtures.generate(LOGN_SEG, fixdir, device="cuda")
    gen_seg_s = time.perf_counter() - t0
    gen_counts = dict(D.counts)
    log(f"  generated in {gen_seg_s:.1f}s launches {json.dumps(gen_counts)} "
        f"sha256 {json.dumps(sha256s(zpath, wpath))}")
    need(gen_counts, ("add_mixed_packed", "add_mixed"),
         f"the 2^{LOGN_SEG} fixture generator")
    D.reset_counts()
    seg_cold, seg_peak, prover = prove_and_verify(zpath, wpath, "seg_cold")
    seg_counts = dict(D.counts)
    nwin = -(-GLV_BITS // prover.c_bits)
    groups = nwin // max(g for g in range(1, prover.window_group + 1)
                         if nwin % g == 0)
    slices = 2 * prover.nmax // prover.segment if prover.segment else 1
    log(f"  segment {prover.segment} c_bits {prover.c_bits} slices {slices} "
        f"window groups {groups} launches {json.dumps(seg_counts)}")
    if (prover.nmax, prover.segment, prover.c_bits, nwin // groups) != \
            (1 << LOGN_SEG, seg, seg_c, seg_G):
        raise RuntimeError(
            f"the 2^{LOGN_SEG} prove ran nmax {prover.nmax} segment "
            f"{prover.segment} c {prover.c_bits} group {nwin // groups}, "
            f"phase 2 checked the kernels for {1 << LOGN_SEG}, {seg}, "
            f"{seg_c}, {seg_G}")
    if seg_counts["scan_cols_packed"] != 2 * slices * groups:
        raise RuntimeError(
            f"scan_cols_packed launched {seg_counts['scan_cols_packed']} "
            f"times, expected {2 * slices * groups}")
    need(seg_counts, ("add", "ntt_fused_pass"), f"the 2^{LOGN_SEG} prove")
    seg_warm, seg_peak2 = warm_prove(prover, zpath, wpath, "seg_warm")
    rows_seg, seg_front_peak = front_rows(prover, wpath)
    del rows_seg
    prover.release()
    # the kernels' share of the segmented MSMs, from this run's times at
    # the slice's shapes: one G1 and one G2 scan per slice per group
    def case_ms(name, key):
        return next(c["ms"] for c in results[name]["cases"]
                    if c["case"] == key)
    scan_s = slices * groups * 1e-3 * (
        case_ms("scan_cols_packed", f"g1 K=256 n={seg_lanes[G1P]}") +
        case_ms("scan_cols_packed", f"g2 K=256 n={seg_lanes[G2P_ISO]}"))
    log(json.dumps({f"prove_2^{LOGN_SEG}": {
        "cold": seg_cold, "warm": seg_warm, "setup": prover.setup_phases,
        "msms_scan_kernel_s": scan_s,
        "msms_other_s": seg_warm["msms"] - scan_s,
        "peak_mem_bytes": max(seg_peak, seg_peak2),
        "front_peak_mem_bytes": seg_front_peak,
        "fixture_gen_s": gen_seg_s, "segment": prover.segment,
        "c_bits": prover.c_bits, "slices": slices, "window_groups": groups,
        "card": card}}))

    # ---------------------------------------------------------- phase 7 --
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
                          small_counts, "n=192 dit"),
        "ntt_tail": ("csrc/ntt.cu", "rapidsnark_tpu/ops/fused.py:458",
                     stage_counts, "dif"),
        "add_mixed_packed": ("csrc/curve.cu",
                             "rapidsnark_tpu/ops/fused.py:219", gen_counts,
                             "g1"),
        "add_mixed": ("csrc/curve.cu", "rapidsnark_tpu/ops/fused.py:170",
                      gen_counts, "g2"),
    }
    runs = {"sqchain64": small_counts, f"2^{LOGN_BIG}": big_counts,
            f"2^{LOGN_BIG} per-stage": stage_counts,
            f"2^{LOGN_SEG} generator": gen_counts,
            f"2^{LOGN_SEG}": seg_counts}
    kernels = []
    for name, (src, rep, counts, pick) in meta.items():
        ent = results[name]
        main_case = next(c for c in ent["cases"] if pick in c["case"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "rapidsnark_tpu_torch/" + src, "replaces": rep,
            "launches": counts[name], "max_abs_err": ent["max_abs_err"],
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": None,
            "launches_by_run": {k: v[name] for k, v in runs.items()},
            "cases": ent["cases"]})
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
