"""A circuit with more wires than its domain (fixtures.sqchain_wide_coo)
through the port on the CPU: the generator's bytes against the JAX
package's ref setup, and the single-card Prover, which pads its point
axis to whole MSM segments, against the JAX package's Prover (whole-axis
scan at this size) and ref/groth16.prove. Tolerance: exact bytes."""

import os

import numpy as np
import pytest
import torch

from rapidsnark_tpu.io.zkey import read_zkey as j_read_zkey
from rapidsnark_tpu.io.zkey import write_zkey as jax_write_zkey
from rapidsnark_tpu.prover import Prover as JProver
from rapidsnark_tpu.ref import setup as JS
from rapidsnark_tpu_torch import fixtures as F
from rapidsnark_tpu_torch.io.wtns import read_wtns
from rapidsnark_tpu_torch.io.zkey import read_zkey, write_zkey, zkey_to_ref
from rapidsnark_tpu_torch.prover import Prover
from rapidsnark_tpu_torch.ref import setup as S
from rapidsnark_tpu_torch.ref.field import R_FR
from rapidsnark_tpu_torch.ref.groth16 import prove as ref_prove, verify
from rapidsnark_tpu_torch.utils.limbs import words_to_ints

from test_torch_fixtures import _coo_equal

R, S_ = 1234567890123456789012345678901234567890, 987654321098765432109876543210

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def wide_r1cs(setup_mod, steps, extra):
    """sqchain_r1cs(steps) with the extra wires' pairs written as dict
    rows: pair j's first wire +1 and second -1 in C row j % steps."""
    r1cs = setup_mod.sqchain_r1cs(steps)
    for j in range(extra // 2):
        first = steps + 2 + 2 * j
        r1cs.c_rows[j % steps][first] = 1
        r1cs.c_rows[j % steps][first + 1] = -1
    r1cs.n_vars += extra
    return r1cs


@pytest.mark.parametrize("steps,extra", [(5, 0), (5, 4), (5, 14),
                                         (126, 2), (62, 536)])
def test_sqchain_wide_coo_equals_r1cs_rows(steps, extra):
    """sqchain_wide_coo gives the dict rows entry for entry, in (m, k, s)
    order, with -1 as its residue mod r."""
    got = F.sqchain_wide_coo(steps, extra)
    _coo_equal(got, F.coo_from_r1cs(wide_r1cs(S, steps, extra)))
    assert got.n_vars == steps + 2 + extra
    with pytest.raises(ValueError):
        F.sqchain_wide_coo(steps, 3)


@pytest.mark.parametrize("steps,extra", [(5, 14), (62, 536)])
def test_wide_witness_satisfies_every_constraint(steps, extra):
    """(A w)(B w) = C w on every row, the pairs cancelling in value; every
    pair's value is a residue below r, the same on both of its wires and
    different from pair to pair."""
    r1cs = wide_r1cs(S, steps, extra)
    w = F.wide_witness(steps, 3, extra, seed=6)
    assert len(w) == r1cs.n_vars
    for a, b, c in zip(r1cs.a_rows, r1cs.b_rows, r1cs.c_rows):
        dot = [sum(v * w[s] for s, v in row.items()) % R_FR
               for row in (a, b, c)]
        assert dot[0] * dot[1] % R_FR == dot[2]
    pairs = w[steps + 2:]
    assert pairs[0::2] == pairs[1::2]
    assert len(set(pairs[0::2])) == extra // 2
    assert all(0 < v < R_FR for v in pairs)


def test_wide_fast_setup_bytes_match_jax_setup_2_6(tmp_path):
    """The generator's zkey for the wide circuit (domain 2^6, 20 extra
    wires: real C points, infinity A and B points) is the JAX package's
    setup + write_zkey, byte for byte."""
    steps, extra, seed = 62, 20, "bench-6-w20"
    zk = F.fast_setup(F.sqchain_wide_coo(steps, extra), seed=seed,
                      device="cpu")
    assert zk.domain_size == 64 and zk.n_vars == 84
    port = tmp_path / "port.zkey"
    write_zkey(str(port), zk)
    jax = tmp_path / "jax.zkey"
    jax_write_zkey(str(jax), JS.setup(wide_r1cs(JS, steps, extra),
                                      seed=seed))
    assert port.read_bytes() == jax.read_bytes()
    # every extra wire has a real C point and infinity A / B points
    c_rows = zk.points_c[-extra:]
    assert (c_rows != 0).any(axis=(1, 2)).all()
    assert not zk.points_a[-extra:].any() and not zk.points_b2[-extra:].any()


def test_wide_prover_pads_to_whole_segments(tmp_path):
    """Domain 64 and 600 wires: 768 padded points do not split into
    slices of 512, so the Prover pads its axis to 1024 points (two whole
    segments) where the JAX package's Prover falls back to the whole
    axis; for a fixed (r, s) the proof is byte-equal to the JAX package's
    and to ref/groth16.prove, and pairing-verifies."""
    steps, extra = 62, 536
    zpath, wpath = F.generate(6, str(tmp_path), device="cpu", extra=extra)
    assert os.path.basename(zpath) == "sqchainw64.zkey"
    zk, wt = read_zkey(zpath), read_wtns(wpath)
    assert (zk.domain_size, zk.n_vars) == (64, 600)
    prover = Prover(zk, window_bits=8, window_group=16, segment=512,
                    device="cpu")
    assert prover.segment == 512 and prover.nmax == 1024
    assert prover.nmax % prover.segment == 0
    assert prover.tables()["pts_g1"].shape == (4, 1024, 2, 8)
    proof, publics = prover.prove(wt.values, r=R, s=S_)
    ref_zk = zkey_to_ref(zk)
    witness = words_to_ints(wt.values)
    assert witness == F.wide_witness(steps, 3, extra, 6)
    expect = ref_prove(ref_zk, witness, r=R, s=S_)
    assert (proof.a, proof.b, proof.c) == (expect.a, expect.b, expect.c)
    assert verify(ref_zk, proof, publics)
    jp = JProver(j_read_zkey(zpath), window_bits=8, segment=512)
    assert (jp.segment, jp.nmax) == (0, 768)
    jproof, jpub = jp.prove(np.asarray(wt.values), r=R, s=S_)
    assert (proof.a, proof.b, proof.c) == (jproof.a, jproof.b, jproof.c)
    assert publics == jpub
