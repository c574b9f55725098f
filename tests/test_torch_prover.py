"""Port prover (rapidsnark_tpu_torch/prover.py) vs the JAX package's
Prover on the committed fixtures, on the CPU.

Tolerances: the MSM scalar rows are word-identical; proofs for a fixed
(r, s) are byte-identical (affine outputs are unique) and pairing-verify.
"""

import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rapidsnark_tpu.io.wtns import read_wtns as j_read_wtns
from rapidsnark_tpu.io.zkey import read_zkey as j_read_zkey
from rapidsnark_tpu.prover import Prover as JProver
from rapidsnark_tpu_torch import convert
from rapidsnark_tpu_torch.io.wtns import read_wtns
from rapidsnark_tpu_torch.io.zkey import read_zkey, zkey_to_ref
from rapidsnark_tpu_torch.prover import Prover
from rapidsnark_tpu_torch.ref.groth16 import prove as ref_prove, verify
from rapidsnark_tpu_torch.utils.limbs import words_to_ints
from rapidsnark_tpu_torch.utils.logger import get_logger

from conftest import FIXTURES

R, S = 1234567890123456789012345678901234567890, 987654321098765432109876543210

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def _load(fixture):
    return (read_zkey(os.path.join(FIXTURES, f"{fixture}.zkey")),
            read_wtns(os.path.join(FIXTURES, f"{fixture}.wtns")))


def _wit(values) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(values).view(np.int32))


@pytest.mark.parametrize("fixture", ["multiplier", "sqchain64",
                                     "sqchain4096"])
def test_front_rows_word_identical(fixture):
    """Rows [h, wit, c] equal the JAX front's, from the port's own tables
    and from the JAX Prover's tables carried across by convert."""
    jzk = j_read_zkey(os.path.join(FIXTURES, f"{fixture}.zkey"))
    jwt = j_read_wtns(os.path.join(FIXTURES, f"{fixture}.wtns"))
    jp = JProver(jzk, window_bits=4)
    jtables = jp.tables()
    want = np.asarray(jp._front_jit(jnp.asarray(jwt.values), jtables))
    zk, wt = _load(fixture)
    tp = Prover(zk, window_bits=4, device="cpu")
    got = tp.front(_wit(wt.values), tp.tables())
    assert np.array_equal(got.numpy().view(np.uint32), want)
    carried = convert.tables_from_jax(jax.tree.map(np.asarray, jtables))
    got2 = tp.front(_wit(wt.values), carried)
    assert np.array_equal(got2.numpy().view(np.uint32), want)
    # and back: the port's tables in the JAX layout are the JAX tables
    back = convert.tables_to_numpy(tp.tables())
    for k in ("coef_s", "coef_val"):
        assert np.array_equal(back[k], np.asarray(jtables[k]))
    assert all(np.array_equal(a, np.asarray(b)) for a, b in
               zip(back["pts_g1"], jtables["pts_g1"]))


@pytest.mark.parametrize("fixture", ["multiplier", "sqchain64"])
def test_proof_byte_identical(fixture, monkeypatch):
    """The proof for a fixed (r, s) against the oracle's and the JAX
    package's; with no profiler and the log above trace the spans are
    off: the prove makes no profiler range and no CUDA event, and
    last_phases holds the four coarse spans alone."""
    zk, wt = _load(fixture)
    prover = Prover(zk, window_bits=4, device="cpu")

    def refused(*a, **k):
        raise AssertionError("a span made a profiler range or CUDA event")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    log = get_logger()
    level = log.level
    log.setLevel(logging.INFO)
    try:
        proof, publics = prover.prove(wt.values, r=R, s=S)
    finally:
        log.setLevel(level)
    assert set(prover.last_phases) == {"front", "msms", "host", "total"}
    ref_zk = zkey_to_ref(zk)
    witness = words_to_ints(wt.values)
    expect = ref_prove(ref_zk, witness, r=R, s=S)
    assert (proof.a, proof.b, proof.c) == (expect.a, expect.b, expect.c)
    assert publics == witness[1:zk.n_public + 1]
    assert verify(ref_zk, proof, publics)
    # and the JAX package's own Prover, byte for byte
    jzk = j_read_zkey(os.path.join(FIXTURES, f"{fixture}.zkey"))
    jproof, jpub = JProver(jzk, window_bits=4).prove(wt.values, r=R, s=S)
    assert (proof.a, proof.b, proof.c) == (jproof.a, jproof.b, jproof.c)
    assert publics == jpub


def test_segmented_proof_byte_identical(monkeypatch):
    """Prover(segment=256) on sqchain64 (256 padded points: two slices of
    the GLV entry axis, the second on phi images): the proof equals the
    unsegmented port's and the JAX package's Prover(segment=256), byte
    for byte; the arguments win over the environment and a segment that
    is not a multiple of the scan's 256-column chunk falls back to the
    whole axis (a slice of 128 or 192 entries cannot be scanned)."""
    zk, wt = _load("sqchain64")
    monkeypatch.setenv("RSTPU_MSM_SEGMENT", "512")
    monkeypatch.setenv("RSTPU_WINDOW_GROUP", "3")
    seg = Prover(zk, window_bits=4, window_group=8, segment=256,
                 device="cpu")
    assert (seg.segment, seg.window_group, seg.nmax) == (256, 8, 256)
    assert Prover(zk, window_bits=4, device="cpu").segment == 512
    assert Prover(zk, window_bits=4, segment=192, device="cpu").segment == 0
    assert Prover(zk, window_bits=4, segment=128, device="cpu").segment == 0
    whole = Prover(zk, window_bits=4, window_group=8, segment=0,
                   device="cpu")
    assert (whole.segment, whole.window_group) == (0, 8)
    assert set(seg.setup_phases) == {"table_stage", "table_copy",
                                     "g2_rescale", "coef_binning",
                                     "ntt_plan"}
    proof, publics = seg.prove(wt.values, r=R, s=S)
    wproof, wpub = whole.prove(wt.values, r=R, s=S)
    assert (proof.a, proof.b, proof.c) == (wproof.a, wproof.b, wproof.c)
    assert publics == wpub
    assert verify(zkey_to_ref(zk), proof, publics)
    jzk = j_read_zkey(os.path.join(FIXTURES, "sqchain64.zkey"))
    jp = JProver(jzk, window_bits=4, window_group=8, segment=256)
    assert jp.segment == 256
    jproof, jpub = jp.prove(wt.values, r=R, s=S)
    assert (proof.a, proof.b, proof.c) == (jproof.a, jproof.b, jproof.c)
    assert publics == jpub


def test_sequential_ntt_rows_word_identical(monkeypatch):
    """RSTPU_NTT_SEQ=1 (a, b, c transformed one at a time): the rows of
    sqchain64 equal the stacked configuration's and the JAX package's
    Prover.front under the same switch, word for word."""
    zk, wt = _load("sqchain64")
    monkeypatch.setenv("RSTPU_NTT_SEQ", "0")
    stacked = Prover(zk, window_bits=4, device="cpu")
    monkeypatch.setenv("RSTPU_NTT_SEQ", "1")
    seq = Prover(zk, window_bits=4, device="cpu")
    assert seq.ntt_seq and not stacked.ntt_seq
    calls = []
    import rapidsnark_tpu_torch.prover as tprover
    real = tprover.to_odd_coset
    monkeypatch.setattr(tprover, "to_odd_coset",
                        lambda x, a: calls.append(tuple(x.shape)) or real(x, a))
    rows_seq = seq.front(_wit(wt.values), seq.tables())
    rows_stacked = stacked.front(_wit(wt.values), stacked.tables())
    n = zk.domain_size
    assert calls == [(n, 8)] * 3 + [(3, n, 8)]
    assert torch.equal(rows_seq, rows_stacked)
    jzk = j_read_zkey(os.path.join(FIXTURES, "sqchain64.zkey"))
    jp = JProver(jzk, window_bits=4)
    assert jp.ntt_seq
    want = np.asarray(jp._front_jit(jnp.asarray(wt.values), jp.tables()))
    assert np.array_equal(rows_seq.numpy().view(np.uint32), want)


def test_release_drops_tables():
    zk, _ = _load("multiplier")
    prover = Prover(zk, window_bits=4, device="cpu")
    assert prover.tables()["pts_g1"].shape == (4, prover.nmax, 2, 8)
    prover.release()
    assert prover.pts_g1 is None and prover.ntt_arrays == {}
    with pytest.raises(RuntimeError, match="release"):
        prover.tables()


def test_wrong_curve_rejected():
    zk, _ = _load("multiplier")
    zk.r = zk.r + 2
    with pytest.raises(ValueError, match="bn128"):
        Prover(zk, window_bits=4, device="cpu")
