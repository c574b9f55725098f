"""The port's fixture generator (rapidsnark_tpu_torch/fixtures.py) with
its scalars on the device, against the JAX package's ref setup and zkey
writer, on the CPU; and the choice of stacked or sequential NTTs for
2^22-2^24 proves against the JAX package's. Tolerance: exact bytes and
words."""

import numpy as np
import pytest
import torch

from rapidsnark_tpu import config as JC
from rapidsnark_tpu.io.zkey import write_zkey as jax_write_zkey
from rapidsnark_tpu.ref import setup as JS
from rapidsnark_tpu_torch import config as TC, fixtures as F
from rapidsnark_tpu_torch.io.zkey import write_zkey
from rapidsnark_tpu_torch.ops.field import FQ, FR
from rapidsnark_tpu_torch.ops.ntt import ints_to_words
from rapidsnark_tpu_torch.ref import curve as TCURVE, setup as S
from rapidsnark_tpu_torch.ref.field import FQ_CTX, P, R_FR
from rapidsnark_tpu_torch.utils.limbs import words_to_ints

from test_torch_field import limbs, rand_vals, to_t

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def _coo_equal(a, b):
    assert (a.n_vars, a.n_public, a.n_constraints) == \
        (b.n_vars, b.n_public, b.n_constraints)
    for f in ("m", "k", "s", "value"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("steps", [1, 2, 5, 126])
def test_sqchain_coo_equals_r1cs_rows(steps):
    """The numpy COO builder gives sqchain_r1cs's dict rows, entry for
    entry, in (m, k, s) order; -k is its residue mod r (0 for k = 0)."""
    got = F.sqchain_coo(steps)
    _coo_equal(got, F.coo_from_r1cs(S.sqchain_r1cs(steps)))
    assert got.m.shape == (4 * steps,)


def test_public_rows_are_ref_setups_extended_a_matrix():
    r1cs = S.sqchain_r1cs(9)
    ext = S.R1CS(r1cs.n_vars, r1cs.n_public,
                 r1cs.a_rows + [{i: 1} for i in range(r1cs.n_public + 1)],
                 r1cs.b_rows + [{}] * (r1cs.n_public + 1),
                 r1cs.c_rows + [{}] * (r1cs.n_public + 1))
    want = F.coo_from_r1cs(ext)
    want.n_constraints = 9
    _coo_equal(F._with_public_rows(F.sqchain_coo(9)), want)


@pytest.mark.parametrize("field", ["FQ", "FR"])
def test_batch_inv_dev(field):
    ops, mod = (FQ, P) if field == "FQ" else (FR, R_FR)
    vals = [v or 1 for v in rand_vals(mod - 1, 37, seed=9)]
    z = ops.to_mont(to_t(limbs(vals)))
    got = ops.from_mont(F._batch_inv_dev(z, ops))
    want = [pow(v, -1, mod) for v in vals]
    assert np.array_equal(got.numpy(), limbs(want).astype(np.int64))


def _jax_bytes(tmp_path, logn):
    steps = (1 << logn) - 2
    zk = JS.setup(JS.sqchain_r1cs(steps), seed=f"bench-{logn}")
    path = tmp_path / "jax.zkey"
    jax_write_zkey(str(path), zk)
    return path.read_bytes()


def _port_bytes(tmp_path, logn):
    parts = {}
    zk = F.fast_setup(F.sqchain_coo((1 << logn) - 2), seed=f"bench-{logn}",
                      device="cpu", parts=parts)
    assert {"rows", "scalars", "points_a", "points_b2", "points_h",
            "vk"} <= set(parts)
    assert isinstance(zk.coefs, np.ndarray)
    path = tmp_path / "port.zkey"
    write_zkey(str(path), zk)
    return path.read_bytes()


def test_fast_setup_bytes_match_jax_setup_2_6(tmp_path):
    """Device scalars, COO rows, the real fixed-base ladders and the
    streamed writer give the JAX package's setup + write_zkey bytes."""
    assert _port_bytes(tmp_path, 6) == _jax_bytes(tmp_path, 6)


class _EncG1:
    """k * G1 stands for (k, 0): a point table that spells out its
    scalars (0 = infinity), so a bigger setup's scalars are compared
    without the pure-Python scalar multiplications."""
    @staticmethod
    def mul(_, k):
        k %= R_FR
        return (k, 0) if k else None


class _EncG2:
    @staticmethod
    def mul(_, k):
        k %= R_FR
        return ((k, 0), (0, 0)) if k else None


def _enc_table(words, coords):
    ks = words_to_ints(words.cpu().numpy().view(np.uint32))
    out = np.zeros((len(ks), coords, 8), np.uint32)
    if ks:
        out[:, 0] = ints_to_words([FQ_CTX.to_mont(k) for k in ks])
    return out


def test_fast_setup_scalars_match_jax_setup_2_8(tmp_path, monkeypatch):
    """At 2^8 every scalar of the setup (both tables of A and B, C, H,
    IC, the vk and the coefficient records) against the JAX package's
    setup + write_zkey, with the scalar multiplications on both sides
    replaced by the encoding above (the ladders are held at 2^6)."""
    for mod in (JS, TCURVE):
        monkeypatch.setattr(mod, "G1", _EncG1)
        monkeypatch.setattr(mod, "G2", _EncG2)
    monkeypatch.setattr(F, "fixed_base_g1", lambda w: _enc_table(w, 2))
    monkeypatch.setattr(F, "fixed_base_g2", lambda w: _enc_table(w, 4))
    assert _port_bytes(tmp_path, 8) == _jax_bytes(tmp_path, 8)


@pytest.mark.parametrize("logn", [22, 23, 24])
def test_big_prove_ntt_sequential_matches_jax(logn, monkeypatch):
    """At 2^22-2^24 the front transforms a, b, c as one stack or one at
    a time (config.ntt_sequential) as the JAX package does: a stack at
    2^22, one at a time from 2^23."""
    monkeypatch.delenv("RSTPU_NTT_SEQ", raising=False)
    assert TC.ntt_sequential(logn) == JC.ntt_sequential(logn) == \
        (logn >= 23)
