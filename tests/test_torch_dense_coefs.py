"""Denser coefficient sections through the port's front
(rapidsnark_tpu_torch/prover.py, ops/front.fr_slot_acc), against the JAX
package's Prover on the CPU: the cases of tests/test_dense_coefs.py (a
row of 100 terms, which spills past K slots; a row of 2^15 + 700 terms,
which the JAX package sums in two levels; the sparse multiplier), and
sqchain64 with every record split in three distinct parts (K = 3).

Tolerances: the MSM scalar rows are word-identical to the JAX front's;
proofs for a fixed (r, s) are byte-identical to ref/groth16.prove (affine
outputs are unique) and pairing-verify; the coefficient tables in the
JAX layout equal the JAX Prover's.
"""

import os
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rapidsnark_tpu.io.zkey import read_zkey as j_read_zkey
from rapidsnark_tpu.prover import Prover as JProver
from rapidsnark_tpu_torch import convert
from rapidsnark_tpu_torch.fixtures import split_coefs
from rapidsnark_tpu_torch.io.wtns import read_wtns
from rapidsnark_tpu_torch.io.zkey import read_zkey, zkey_to_ref
from rapidsnark_tpu_torch.prover import Prover
from rapidsnark_tpu_torch.ref.field import R_FR
from rapidsnark_tpu_torch.ref.groth16 import prove as ref_prove, verify
from rapidsnark_tpu_torch.utils.limbs import words_to_ints

from conftest import FIXTURES

R, S = 1122334455, 9988776655

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def _words(vals) -> np.ndarray:
    return np.stack([np.frombuffer(int(v).to_bytes(32, "little"),
                                   dtype="<u4") for v in vals])


def _split_one(vals: np.ndarray, idx: int, k: int, seed: int):
    """(counts, values): record idx in k random parts that sum to it."""
    rng = random.Random(seed)
    orig = words_to_ints(vals[idx:idx + 1])[0]
    parts = [rng.randrange(R_FR) for _ in range(k - 1)]
    parts.append((orig - sum(parts)) % R_FR)
    counts = np.ones(vals.shape[0], np.int64)
    counts[idx] = k
    return counts, np.concatenate([vals[:idx], _words(parts),
                                   vals[idx + 1:]])


def _split_all_three(vals: np.ndarray):
    """(counts, values): every record v as v*c1, v*c2, v*(1 - c1 - c2),
    three distinct parts (Montgomery form is linear)."""
    c1, c2 = 0x1234567 + (1 << 200), 0x89ABCDEF + (1 << 190)
    out = []
    for v in words_to_ints(vals):
        p1, p2 = v * c1 % R_FR, v * c2 % R_FR
        out += [p1, p2, (v - p1 - p2) % R_FR]
    return np.full(vals.shape[0], 3, np.int64), _words(out)


CASES = {
    # fixture, split, the port's K, spilled?, two-level in the JAX layout?
    "spill_100": ("multiplier", lambda v: _split_one(v, 0, 100, 91), None,
                  True, False),
    "two_level": ("multiplier",
                  lambda v: _split_one(v, 0, (1 << 15) + 700, 92), None,
                  True, True),
    "sparse": ("multiplier", None, None, False, False),
    "sqchain64_k3": ("sqchain64", _split_all_three, 3, False, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_front_rows_and_proof(case):
    fixture, split, slots, spilled, two_level = CASES[case]
    zk = read_zkey(os.path.join(FIXTURES, f"{fixture}.zkey"))
    jzk = j_read_zkey(os.path.join(FIXTURES, f"{fixture}.zkey"))
    wt = read_wtns(os.path.join(FIXTURES, f"{fixture}.wtns"))
    if split is not None:
        counts, vals = split(np.asarray(zk.coef_val))
        zk = split_coefs(zk, counts, vals)
        jzk = split_coefs(jzk, counts, vals)
    tp = Prover(zk, window_bits=4, device="cpu")
    jp = JProver(jzk, window_bits=4)
    assert tp.coef_slots == jp.coef_slots
    if slots is not None:
        assert tp.coef_slots == slots
    assert (tp.left_s is not None) == spilled
    assert (tp.acc2_seg is not None) == two_level
    jtables = jax.tree.map(np.asarray, jp.tables())

    # the rows, from the port's tables and from the JAX Prover's carried
    # across (their sorted spill list built by convert)
    want = np.asarray(jp._front_jit(jnp.asarray(wt.values), jp.tables()))
    wit = torch.from_numpy(np.ascontiguousarray(wt.values).view(np.int32))
    got = tp.front(wit, tp.tables())
    assert np.array_equal(got.numpy().view(np.uint32), want)
    carried = convert.tables_from_jax(jtables)
    assert np.array_equal(
        tp.front(wit, carried).numpy().view(np.uint32), want)
    if spilled:
        for k in ("left_order", "left_off"):
            assert torch.equal(carried[k], tp.tables()[k])

    # the coefficient tables, back in the JAX layout
    back = convert.tables_to_numpy(tp.tables())
    for k in ("coef_s", "coef_val", "left_s", "left_val", "left_seg",
              "acc2_seg"):
        assert (k in back) == (k in jtables), k
        if k in back:
            assert np.array_equal(back[k], jtables[k]), k

    # the proof, byte for byte
    proof, publics = tp.prove(wt.values, r=R, s=S)
    ref_zk = zkey_to_ref(zk)
    expect = ref_prove(ref_zk, words_to_ints(wt.values), r=R, s=S)
    assert (proof.a, proof.b, proof.c) == (expect.a, expect.b, expect.c)
    assert verify(ref_zk, proof, publics)
