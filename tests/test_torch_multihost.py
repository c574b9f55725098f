"""Sharded proving in the port (Prover(mesh=), the CLI's environment
knobs, tools/dist_prove_worker, FullProver(mesh=)) on gloo ranks on the
CPU, against the JAX package's Prover over its 8-device mesh and the
byte-level oracle (ref/groth16.prove), as tests/test_multihost.py and
tests/test_parallel.py hold the JAX package.

Tolerance: proofs for a fixed (r, s) are byte-identical (affine outputs
are unique), on every rank; proofs with random blinding pairing-verify."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from rapidsnark_tpu.io.wtns import read_wtns as j_read_wtns
from rapidsnark_tpu.io.zkey import read_zkey as j_read_zkey
from rapidsnark_tpu.prover import Prover as JProver
from rapidsnark_tpu_torch import cli
from rapidsnark_tpu_torch.io.wtns import read_wtns
from rapidsnark_tpu_torch.io.zkey import read_zkey, zkey_to_ref
from rapidsnark_tpu_torch.parallel import launch, multihost as MH
from rapidsnark_tpu_torch.prover import Prover
from rapidsnark_tpu_torch.ref.groth16 import Proof, prove as ref_prove, verify
from rapidsnark_tpu_torch.utils.limbs import words_to_ints

from conftest import FIXTURES

R, S = 31415926, 27182818
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZKEY = os.path.join(FIXTURES, "sqchain64.zkey")
WTNS = os.path.join(FIXTURES, "sqchain64.wtns")
# c = 8 in one window group: one plain scan a curve (the plain scan is
# 256 sequential adds); the proof does not depend on the windows
KNOBS = {"RSTPU_WINDOW_BITS": "8", "RSTPU_WINDOW_GROUP": "16"}

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _json(proof: Proof) -> dict:
    return proof.to_json_dict()


@pytest.fixture(scope="module")
def expected():
    """The oracle's proof of sqchain64 for (R, S), which the JAX
    package's Prover over its 8-device mesh gives byte for byte."""
    zk = read_zkey(ZKEY)
    want = ref_prove(zkey_to_ref(zk), words_to_ints(read_wtns(WTNS).values),
                     r=R, s=S)
    mesh = JMesh(np.array(jax.devices()), ("shard",))
    jp = JProver(j_read_zkey(ZKEY), window_bits=4, mesh=mesh)
    got, _ = jp.prove(j_read_wtns(WTNS).values, r=R, s=S)
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    return _json(want)


def _prove_rank(mesh):
    """sqchain64 on this rank; ranks past 0 pass another r, which rank
    0's replaces."""
    prover = Prover(read_zkey(ZKEY), window_bits=8, window_group=16,
                    mesh=mesh)
    proof, pub = prover.prove(read_wtns(WTNS).values,
                              r=R + mesh.rank, s=S)
    plan = prover.dntt_plan
    return {"proof": _json(proof), "publics": pub, "nmax": prover.nmax,
            "four_step": None if plan is None else (plan.n1, plan.n2),
            "phases": prover.last_phases}


@pytest.mark.parametrize("nd,four_step", [(2, (16, 8)), (3, None)])
def test_mesh_prover_byte_identical(expected, nd, four_step):
    """D = 2 runs the four-step NTT (N = 128 = 16 x 8), D = 3 the
    replicated whole-domain NTT (3 divides neither); both pad the MSMs to
    whole scan chunks a rank, and every rank's proof is the oracle's."""
    outs = launch.run_ranks(_prove_rank, nd, device="cpu", timeout=900)
    for out in outs:
        assert out["proof"] == expected
        assert out["four_step"] == four_step
        assert out["nmax"] % (256 * nd) == 0
    ph = outs[0]["phases"]
    assert ph["broadcast_calls"] == 1
    assert ph["all_gather_calls"] == (3 if four_step else 2)
    assert ph.get("all_to_all_calls", 0) == (6 if four_step else 0)


def test_two_workers_by_env_knobs(expected, tmp_path):
    """Two tools/dist_prove_worker processes joined by RSTPU_COORD /
    RSTPU_NPROCS / RSTPU_PROC_ID (gloo on the CPU) write the oracle's
    proof, both of them."""
    port = _free_port()
    env = {**os.environ, **KNOBS, "RSTPU_COORD": f"127.0.0.1:{port}",
           "RSTPU_NPROCS": "2"}
    code = ("import sys, torch; torch.set_num_threads(1); "
            "from rapidsnark_tpu_torch.tools import dist_prove_worker as W; "
            "sys.exit(W.main(sys.argv[1:]))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, ZKEY, WTNS, str(tmp_path), str(R),
         str(S), "cpu"], cwd=REPO, env={**env, "RSTPU_PROC_ID": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    lines = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    assert [ln["rank"] for ln in lines] == [0, 1]
    assert all(ln["backend"] == "gloo" and ln["size"] == 2 for ln in lines)
    for i in range(2):
        with open(tmp_path / f"proof_{i}.json") as f:
            assert json.load(f) == expected
        with open(tmp_path / f"public_{i}.json") as f:
            assert json.load(f) == [str(v) for v in words_to_ints(
                read_wtns(WTNS).values[1:2])]


def _verify_files(proof_p, pub_p):
    with open(proof_p) as f:
        pj = json.load(f)
    with open(pub_p) as f:
        pub = [int(v) for v in json.load(f)]
    proof = Proof(a=(int(pj["pi_a"][0]), int(pj["pi_a"][1])),
                  b=((int(pj["pi_b"][0][0]), int(pj["pi_b"][0][1])),
                     (int(pj["pi_b"][1][0]), int(pj["pi_b"][1][1]))),
                  c=(int(pj["pi_c"][0]), int(pj["pi_c"][1])))
    return verify(zkey_to_ref(read_zkey(ZKEY), tables=False), proof, pub)


def test_cli_env_knobs_one_rank(tmp_path, monkeypatch):
    """The CLI with RSTPU_COORD / RSTPU_NPROCS=1 / RSTPU_PROC_ID=0 joins
    a job of one rank (gloo on the CPU), proves on its mesh, writes a
    proof that pairing-verifies, and leaves the job."""
    for k, v in {**KNOBS, "RSTPU_COORD": f"127.0.0.1:{_free_port()}",
                 "RSTPU_NPROCS": "1", "RSTPU_PROC_ID": "0"}.items():
        monkeypatch.setenv(k, v)
    holder = []
    proof_p, pub_p = tmp_path / "proof.json", tmp_path / "public.json"
    cli.run_prove(ZKEY, WTNS, str(proof_p), str(pub_p), device="cpu",
                  prover_out=holder)
    mesh = holder[0].mesh
    assert (mesh.size, mesh.backend) == (1, "gloo")
    assert holder[0].last_phases["all_to_all_calls"] == 6
    assert not torch.distributed.is_initialized()
    assert _verify_files(proof_p, pub_p)


def test_full_prover_on_a_mesh(tmp_path, monkeypatch):
    """A sqchain64 request through FullProver(mesh=) on a one-rank gloo
    mesh: every Prover of the registry is the rank's; the proof served
    pairing-verifies."""
    from rapidsnark_tpu_torch.server.fullprover import FullProver

    def witness(circuit, input_path, wtns_path):
        with open(WTNS, "rb") as src, open(wtns_path, "wb") as dst:
            dst.write(src.read())

    monkeypatch.setenv("RSTPU_WINDOW_GROUP", KNOBS["RSTPU_WINDOW_GROUP"])
    MH.initialize(num_processes=1, process_id=0, device="cpu",
                  init_method="file://" + str(tmp_path / "store"))
    try:
        mesh = MH.global_mesh("cpu")
        fp = FullProver([ZKEY], build_dir=str(tmp_path / "build"),
                        window_bits=8, device="cpu", mesh=mesh,
                        witness_generator=witness)
        assert fp.provers["sqchain64"].mesh is mesh
        fp.start_prove("{}", "sqchain64")
        t0 = time.time()
        while fp.get_status()["status"] == "busy" and time.time() - t0 < 600:
            time.sleep(0.05)
        st = fp.get_status()
    finally:
        MH.shutdown()
    assert st["status"] == "success", st
    proof_p, pub_p = tmp_path / "proof.json", tmp_path / "public.json"
    proof_p.write_text(st["proof"])
    pub_p.write_text(st["pubData"])
    assert _verify_files(proof_p, pub_p)


def test_no_hidden_fallback(monkeypatch):
    """A card that is not there raises, in initialize and in a Prover on
    a mesh on it; a job of one with nothing set is no job; NCCL with two
    ranks on one card raises the port's own error before NCCL starts."""
    assert MH.initialize() is None and not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MH.initialize(num_processes=2, process_id=0,
                      coordinator="127.0.0.1:1", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prover(read_zkey(ZKEY), mesh=MH.Mesh("cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="one card a rank"):
        MH.initialize(num_processes=2, process_id=1,
                      coordinator="127.0.0.1:1", device="cuda")
    assert not torch.distributed.is_initialized()


def test_profile_trace(tmp_path, monkeypatch):
    """RSTPU_PROFILE=<dir>: each prove writes a torch.profiler trace, which
    holds the port's spans as "rstpu.<key>" ranges, each inside its
    parent's; the profiled prove's last_phases hold the same keys (host
    seconds on the CPU), the MSM's five stages within msms."""
    monkeypatch.setenv("RSTPU_PROFILE", str(tmp_path / "prof"))
    prover = Prover(read_zkey(os.path.join(FIXTURES, "multiplier.zkey")),
                    window_bits=8, window_group=16, device="cpu")
    wt = read_wtns(os.path.join(FIXTURES, "multiplier.wtns"))
    prover.prove(wt.values, r=R, s=S)
    first = prover.last_trace
    prover.prove(wt.values, r=R, s=S)
    assert first != prover.last_trace
    stages = [f"msms.{k}" for k in ("prep", "sort", "gather", "scan",
                                    "buckets")]
    keys = ["front", "front.upload", "msms"] + stages
    for path in (first, prover.last_trace):
        assert os.path.dirname(path) == str(tmp_path / "prof")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("ph") == "X" for e in events)
        spans = {}
        for e in events:
            if e.get("cat") == "user_annotation" and \
                    e["name"].startswith("rstpu."):
                spans.setdefault(e["name"][len("rstpu."):], []).append(
                    (e["ts"], e["ts"] + e["dur"]))
        assert set(keys) <= set(spans)
        for k in keys[1:]:
            parent = k.rsplit(".", 1)[0] if k != "msms" else None
            for lo, hi in spans[k] if parent else ():
                assert any(plo <= lo and hi <= phi
                           for plo, phi in spans[parent]), k
    got = prover.last_phases
    assert set(keys) <= set(got) and all(got[k] > 0 for k in keys)
    assert sum(got[k] for k in stages) <= got["msms"]


def test_block_events_split_after_the_lead():
    """device.block_events: a traced block's card events are those that
    start after the last lead kernel ends, on the card's timeline (a host
    range does not split them); a trace without a lead kernel raises."""
    from types import SimpleNamespace
    from rapidsnark_tpu_torch import device as D
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, lo, hi, kind=cuda):
        return SimpleNamespace(name=name, device_type=kind,
                               time_range=SimpleNamespace(start=lo, end=hi))

    lead = [ev(f"void at::cuda::{D.TRACE_LEAD}(long)", 0, 270),
            ev(f"void at::cuda::{D.TRACE_LEAD}(long)", 271, 272)]
    block = [ev("k_sort_count", 280, 290), ev("Memcpy HtoD", 272, 275),
             ev("k_scan_g1", 300, 400)]
    early = [ev("k_fused_pass", 100, 110), ev("chip_smoke.prove", 0, 500, cpu)]
    # a span's range mirrored on the card's timeline is no card event
    got = D.block_events(lead + early + block
                         + [ev("rstpu.msms.scan", 295, 405)])
    assert [e.name for e in got] == ["k_sort_count", "Memcpy HtoD",
                                     "k_scan_g1"]
    # the long spin lost: the marker alone splits the trace
    assert D.block_events(lead[1:] + block) == block
    with pytest.raises(RuntimeError, match="lost its lead"):
        D.block_events(early + block)
