"""The reference agrees with the port's plain CPU path at 2^6, point for
point, and disagrees when one witness word is changed; the input maker's
key equals the port's own generator's for the same circuit and seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import keygen
from benchmark.circuits import sqchain
from benchmark.entries import zkey_of
from benchmark.frozen.ref_field import R_FR
from benchmark.reference import Reference, publics, verify

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    coo = sqchain.coo(3, 20)
    key = keygen.make_key(coo, "tiny:5", "cpu")
    gen = torch.Generator("cpu")
    gen.manual_seed(5)
    wit = sqchain.witness(3, 20, gen, "cpu")
    return coo, key, wit


def _ints(w):
    return [int.from_bytes(r.astype("<u4").tobytes(), "little") for r in w]


def test_witness_satisfies_every_row(tiny):
    coo, _, wit = tiny
    vals = _ints(wit)
    rows = {}
    for m, k, s, v in zip(coo.m, coo.k, coo.s, coo.value):
        vv = int.from_bytes(v.astype("<u4").tobytes(), "little")
        rows[(m, k)] = (rows.get((m, k), 0) + vv * vals[s]) % R_FR
    for k in range(coo.n_constraints):
        assert rows[(0, k)] * rows[(1, k)] % R_FR == rows[(2, k)]
    assert vals[0] == 1


def test_one_lane_is_the_ports_sqchain():
    from rapidsnark_tpu_torch import fixtures
    from rapidsnark_tpu_torch.ref import setup
    a, b = sqchain.coo(1, 62), fixtures.sqchain_coo(62)
    for f in ("m", "k", "s", "value"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    gen = torch.Generator("cpu")
    gen.manual_seed(9)
    w = _ints(sqchain.witness(1, 62, gen, "cpu"))
    assert w == setup.sqchain_witness(62, w[2])


def test_key_equals_the_ports_generator():
    from rapidsnark_tpu_torch import fixtures
    key = keygen.make_key(sqchain.coo(1, 62), "bench-6", "cpu")
    zk = fixtures.fast_setup(fixtures.sqchain_coo(62), seed="bench-6",
                             device="cpu")
    for nm in ("points_a", "points_b1", "points_b2", "points_c", "points_h",
               "ic"):
        assert np.array_equal(getattr(key, nm), getattr(zk, nm)), nm
    for f in ("m", "c", "s"):
        assert np.array_equal(getattr(key, "coef_" + f), zk.coefs[f])
    assert np.array_equal(key.coef_val, zk.coefs["coef"])
    for nm in ("alpha1", "beta1", "delta1", "beta2", "gamma2", "delta2"):
        assert key.vk[nm] == getattr(zk, "vk_" + nm)


def test_reference_is_the_ports_proof_and_catches_one_word(tiny):
    from rapidsnark_tpu_torch.prover import Prover
    coo, key, wit = tiny
    prover = Prover(zkey_of(key), device="cpu")
    proof, pubs = prover.prove(wit, r=12345, s=678)
    ref = Reference(coo, key.toxic, "cpu")
    assert ref.proof(wit, 12345, 678) == (proof.a, proof.b, proof.c)
    assert pubs == publics(wit, 1)
    assert ref.proof(wit, 12346, 678) != (proof.a, proof.b, proof.c)
    bent = wit.copy()
    bent[30, 3] ^= 1 << 7
    assert ref.proof(bent, 12345, 678)[0] != proof.a
    from benchmark.entries.cli import affine_g1
    ic = [affine_g1(p) for p in key.ic]
    assert verify(key.vk, ic, (proof.a, proof.b, proof.c), pubs)
    assert not verify(key.vk, ic, (proof.a, proof.b, proof.c),
                      [pubs[0] + 1])
