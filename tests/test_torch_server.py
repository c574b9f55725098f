"""The port's proof-service state machine
(rapidsnark_tpu_torch/server/fullprover.py) on the CPU: the reference's
semantics as tests/test_server.py holds them for the JAX package (one
prove at a time, single-slot pending queue, coarse cooperative abort,
status payload shapes), and the port's FullProver against the JAX
package's on the same zkey, input and blinding.

Tolerance: the `proof` and `pubData` strings of the two status payloads
are byte-identical."""

import json
import os
import threading
import time

import torch

from rapidsnark_tpu_torch.ref.field import R_FR
from rapidsnark_tpu_torch.server.fullprover import (FullProver, Status,
                                                    circuit_name)

from conftest import FIXTURES

ZKEY = os.path.join(FIXTURES, "multiplier.zkey")

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)

def _fake_witness_gen(delay: float = 0.0):
    """Stands in for the circom_runtime subprocess (fullprover.cpp:123):
    reads input.json {a, b}, writes the multiplier witness
    [1, a*b, a, b]."""
    from rapidsnark_tpu_torch.io.wtns import write_wtns

    def gen(circuit, input_path, wtns_path):
        if delay:
            time.sleep(delay)
        with open(input_path) as f:
            inp = json.load(f)
        a, b = int(inp["a"]), int(inp["b"])
        write_wtns(wtns_path, [1, a * b % R_FR, a, b])

    return gen


def _wait_done(fp, timeout=900.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        st = fp.get_status()
        if st["status"] != "busy":
            return st
        time.sleep(0.05)
    raise TimeoutError("prover stayed busy")


def test_circuit_name():
    assert circuit_name("/x/y/circuit-400-32-256-64.zkey") == \
        "circuit-400-32-256-64"
    assert circuit_name("plain") == "plain"


def test_prove_success_and_status_shape(tmp_path):
    fp = FullProver([ZKEY], build_dir=str(tmp_path), device="cpu",
                    window_bits=4, witness_generator=_fake_witness_gen())
    assert fp.get_status() == {"status": "ready"}
    fp.start_prove(json.dumps({"a": 3, "b": 5}), "multiplier")
    st = _wait_done(fp)
    assert st["status"] == "success"
    # reference encodes proof/pubData as JSON *strings* (fullprover.cpp:231)
    proof = json.loads(st["proof"])
    pub = json.loads(st["pubData"])
    assert pub == ["15"]
    assert proof["protocol"] == "groth16"

    # the proof must actually verify
    from rapidsnark_tpu_torch.io.zkey import read_zkey, zkey_to_ref
    from rapidsnark_tpu_torch.ref.groth16 import Proof, verify
    ref_zk = zkey_to_ref(read_zkey(ZKEY))
    p = Proof(a=(int(proof["pi_a"][0]), int(proof["pi_a"][1])),
              b=((int(proof["pi_b"][0][0]), int(proof["pi_b"][0][1])),
                 (int(proof["pi_b"][1][0]), int(proof["pi_b"][1][1]))),
              c=(int(proof["pi_c"][0]), int(proof["pi_c"][1])))
    assert verify(ref_zk, p, [15])


def test_failed_prove_reports_error(tmp_path):
    def bad_gen(circuit, input_path, wtns_path):
        raise RuntimeError("witness generator exploded")

    fp = FullProver([ZKEY], build_dir=str(tmp_path), device="cpu",
                    window_bits=4, witness_generator=bad_gen)
    fp.start_prove("{}", "multiplier")
    st = _wait_done(fp)
    assert st["status"] == "failed"
    assert "exploded" in st["error"]


def test_pending_overwrite_and_abort(tmp_path):
    """A request during busy cancels the run and queues the new one
    (fullprover.cpp:72-77); the canceled run never emits a proof."""
    fp = FullProver([ZKEY], build_dir=str(tmp_path), device="cpu",
                    window_bits=4,
                    witness_generator=_fake_witness_gen(delay=1.0))
    fp.start_prove(json.dumps({"a": 1, "b": 2}), "multiplier")
    time.sleep(0.2)  # let the worker enter the slow witness gen
    assert fp.get_status()["status"] == "busy"
    fp.start_prove(json.dumps({"a": 3, "b": 5}), "multiplier")
    st = _wait_done(fp)
    assert st["status"] == "success"
    assert json.loads(st["pubData"]) == ["15"]  # the SECOND request won


def test_abort_when_idle_is_noop(tmp_path):
    fp = FullProver([ZKEY], build_dir=str(tmp_path), device="cpu",
                    window_bits=4,
                    witness_generator=_fake_witness_gen())
    fp.abort()
    assert fp.get_status() == {"status": "ready"}


def test_failed_prove_error_read_during_transition(tmp_path):
    """Concurrent get_status while a failing prove transitions: the
    error-path _err_string write happens under the lock: readers never
    see a torn failed-without-error state and nothing deadlocks."""
    def bad_gen(circuit, input_path, wtns_path):
        time.sleep(0.2)
        raise RuntimeError("late explosion")

    fp = FullProver([ZKEY], build_dir=str(tmp_path), device="cpu",
                    window_bits=4, witness_generator=bad_gen)
    seen, errs = [], []

    def poll():
        for _ in range(400):
            st = fp.get_status()
            seen.append(st["status"])
            if st["status"] == "failed":
                if "error" not in st or "explosion" not in st["error"]:
                    errs.append(st)
                return
            time.sleep(0.01)

    pollers = [threading.Thread(target=poll) for _ in range(4)]
    for t in pollers:
        t.start()
    fp.start_prove("{}", "multiplier")
    for t in pollers:
        t.join()
    assert not errs
    st = fp.get_status()
    assert st["status"] == "failed" and "explosion" in st["error"]


def test_status_during_initializing_and_deferred_start(tmp_path):
    """defer_load: /status answers {} while the registry loads (the
    reference's getStatus has no initializing branch, fullprover.cpp:
    216-240, and its listener isn't even up yet); a prove request that
    arrives during init stays pending and starts after load()."""
    fp = FullProver([ZKEY], build_dir=str(tmp_path), device="cpu",
                    window_bits=4,
                    witness_generator=_fake_witness_gen(),
                    defer_load=True)
    assert fp.status == Status.initializing
    assert fp.get_status() == {}          # exact reference payload
    fp.start_prove(json.dumps({"a": 2, "b": 3}), "multiplier")
    time.sleep(0.1)
    assert fp.status == Status.initializing  # not started during init
    fp.load()
    st = _wait_done(fp)
    assert st["status"] == "success"
    assert json.loads(st["pubData"]) == ["6"]


def test_full_prover_matches_jax_byte_for_byte(tmp_path, monkeypatch):
    """Same zkey, same input, sample_rs patched to the same (r, s) in
    both packages: the success payloads carry identical strings."""
    import rapidsnark_tpu.prover as jprover
    import rapidsnark_tpu_torch.prover as tprover
    from rapidsnark_tpu.io.wtns import write_wtns as j_write_wtns
    from rapidsnark_tpu.server.fullprover import FullProver as JFullProver

    def fixed_rs():
        vals = iter((1234567890123456789012345678901234567890,
                     987654321098765432109876543210))
        return lambda: next(vals)

    def j_gen(circuit, input_path, wtns_path):
        with open(input_path) as f:
            inp = json.load(f)
        a, b = int(inp["a"]), int(inp["b"])
        j_write_wtns(wtns_path, [1, a * b % R_FR, a, b])

    payloads = []
    for mod, make in (
            (tprover, lambda d: FullProver(
                [ZKEY], build_dir=d, window_bits=4, device="cpu",
                witness_generator=_fake_witness_gen())),
            (jprover, lambda d: JFullProver(
                [ZKEY], build_dir=d, window_bits=4,
                witness_generator=j_gen))):
        monkeypatch.setattr(mod, "sample_rs", fixed_rs())
        d = tmp_path / mod.__name__
        d.mkdir()
        fp = make(str(d))
        fp.start_prove(json.dumps({"a": 11, "b": 13}), "multiplier")
        payloads.append(_wait_done(fp))
    got, want = payloads
    assert got["status"] == want["status"] == "success"
    assert got["proof"] == want["proof"]
    assert got["pubData"] == want["pubData"] == '["143"]'


def test_no_card_raises_without_cpu_request(tmp_path):
    """With no CUDA card the service refuses to start unless the caller
    asks for the CPU: nothing is served from the CPU by default."""
    import pytest
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FullProver([ZKEY], build_dir=str(tmp_path), window_bits=4)
