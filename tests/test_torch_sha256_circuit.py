"""The benchmark's SHA-256 circuit family (benchmark/circuits/sha256.py:
circomlib's Sha256compression over Num2Bits(8) bytes, circom --O1) and
the port proving it.

(a) Its witness satisfies every row, over the integers (every wire is a
bit or a byte and every coefficient small, so A.w * B.w = C.w mod r holds
as an integer identity), and each lane's digest bits are hashlib's.
(b) A plain SHA-256 compression in Python ints, stopped after `rounds`,
gives the family's digest words at 2 and 64 rounds.
(c) On a reduced-rounds circuit the port's plain-path proof equals the
benchmark's reference point for point, on a key from benchmark.keygen:
three rounds are the fewest whose rows of four B records make the
port's 5% rule pick K = 3 (at two, K = 2), with records past three slots
spilled.
(d) With spans on, the prove's records hold the front.acc span and the
live-digit counts, and the live count equals a plain count of the
nonzero digits of the five MSMs' scalars.
"""

import hashlib
import logging

import numpy as np
import pytest
import torch

from benchmark import keygen
from benchmark.circuits import sha256 as S
from benchmark.entries import zkey_of
from benchmark.reference import Reference
from rapidsnark_tpu_torch.ops import glv as GLV
from rapidsnark_tpu_torch.ops import msm as MSM
from rapidsnark_tpu_torch.ops.curve import G1P, G2P
from rapidsnark_tpu_torch.prover import Prover
from rapidsnark_tpu_torch.ref.field import R_FR
from rapidsnark_tpu_torch.utils import logger as L

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)

R, S_ = 1122334455, 9988776655

# SHA-256 (FIPS 180-4), written here apart from the family
_K = [int(x, 16) for x in """
428a2f98 71374491 b5c0fbcf e9b5dba5 3956c25b 59f111f1 923f82a4 ab1c5ed5
d807aa98 12835b01 243185be 550c7dc3 72be5d74 80deb1fe 9bdc06a7 c19bf174
e49b69c1 efbe4786 0fc19dc6 240ca1cc 2de92c6f 4a7484aa 5cb0a9dc 76f988da
983e5152 a831c66d b00327c8 bf597fc7 c6e00bf3 d5a79147 06ca6351 14292967
27b70a85 2e1b2138 4d2c6dfc 53380d13 650a7354 766a0abb 81c2c92e 92722c85
a2bfe8a1 a81a664b c24b8b70 c76c51a3 d192e819 d6990624 f40e3585 106aa070
19a4c116 1e376c08 2748774c 34b0bcb5 391c0cb3 4ed8aa4a 5b9cca4f 682e6ff3
748f82ee 78a5636f 84c87814 8cc70208 90befffa a4506ceb bef9a3f7 c67178f2
""".split()]
_H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]
M32 = 0xFFFFFFFF


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & M32


def _compress(h, block: bytes, rounds: int) -> list:
    """The compression of one 64-byte block, stopped after `rounds`
    rounds, with the feed-forward."""
    w = [int.from_bytes(block[4 * t:4 * t + 4], "big") for t in range(16)]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, hh = h
    for t in range(rounds):
        t1 = (hh + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25))
              + ((e & f) ^ (~e & g)) + _K[t] + w[t]) & M32
        t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22))
              + ((a & b) ^ (a & c) ^ (b & c))) & M32
        a, b, c, d, e, f, g, hh = (t1 + t2) & M32, a, b, c, (d + t1) & M32, \
            e, f, g
    return [(x + y) & M32 for x, y in zip(h, (a, b, c, d, e, f, g, hh))]


def _words_of(bits: np.ndarray) -> list:
    """256 digest bits, most significant first -> 8 words."""
    return [int("".join(map(str, bits[32 * j:32 * j + 32])), 2)
            for j in range(8)]


def _padded(lanes, steps, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return S.messages(lanes, steps, gen, "cpu")


def _signed(value: np.ndarray) -> np.ndarray:
    """(n, 8) words of residues -> int64 representatives in (-r/2, r/2)."""
    rows = np.ascontiguousarray(value, "<u4").view(np.dtype((np.void, 32)))
    uniq, inv = np.unique(rows.ravel(), return_inverse=True)
    vals = []
    for row in uniq:
        v = int.from_bytes(row.tobytes(), "little")
        v = v - R_FR if v > R_FR // 2 else v
        assert abs(v) < 1 << 40
        vals.append(v)
    return np.asarray(vals, np.int64)[inv.ravel()]


def test_witness_satisfies_every_row_and_hashes_as_hashlib():
    lanes, steps = 2, 2
    coo = S.coo(lanes, steps)
    assert (coo.n_vars, coo.n_public, coo.n_constraints) == \
        S.sizes(lanes, steps)
    assert np.all(np.diff(coo.m) >= 0)
    key = (coo.m * coo.n_constraints + coo.k) * coo.n_vars + coo.s
    assert np.all(np.diff(key) > 0)                  # sorted, no repeats
    padded = _padded(lanes, steps, 11)
    w = S.chain(lanes, steps, padded)
    assert w.shape == (coo.n_vars, 8) and not w[:, 1:].any()
    wv = w[:, 0].astype(np.int64)
    assert wv[0] == 1 and wv.max() < 256
    prod = np.zeros((3, coo.n_constraints), np.int64)
    np.add.at(prod, (coo.m, coo.k), _signed(coo.value) * wv[coo.s])
    assert np.array_equal(prod[0] * prod[1], prod[2])
    # a changed bit breaks a row
    bent = wv.copy()
    bent[1000] ^= 1
    prod[:] = 0
    np.add.at(prod, (coo.m, coo.k), _signed(coo.value) * bent[coo.s])
    assert not np.array_equal(prod[0] * prod[1], prod[2])
    lane_w = S.lane_values(padded, steps)
    for j in range(lanes):
        msg = padded[j, :64 * steps - 9].tobytes()
        want = np.unpackbits(np.frombuffer(hashlib.sha256(msg).digest(),
                                           np.uint8))
        assert np.array_equal(lane_w[j, -256:], want)
    assert np.array_equal(wv[1:257], lane_w[-1, -256:])   # the publics


@pytest.mark.parametrize("rounds", [2, 64])
def test_compression_state_equals_plain_sha256(rounds):
    lanes, steps = 2, 2
    padded = _padded(lanes, steps, 23)
    lane_w = S.lane_values(padded, steps, rounds=rounds)
    for j in range(lanes):
        h = list(_H0)
        for b in range(steps):
            h = _compress(h, padded[j, 64 * b:64 * b + 64].tobytes(), rounds)
        assert _words_of(lane_w[j, -256:]) == h


@pytest.fixture(scope="module")
def proved():
    """A 1-lane, 1-block, 3-round circuit, its key and witness, and one
    proof by the port on the CPU with spans on."""
    lanes, steps, rounds = 1, 1, 3
    coo = S.coo(lanes, steps, rounds)
    key = keygen.make_key(coo, "sha256-test:1", "cpu")
    gen = torch.Generator()
    gen.manual_seed(5)
    w = S.witness(lanes, steps, gen, "cpu", rounds=rounds)
    prover = Prover(zkey_of(key), window_bits=8, window_group=16,
                    device="cpu")
    log = L.get_logger()
    old = log.level
    log.setLevel(L.TRACE)
    try:
        proof, pubs = prover.prove(w, R, S_)
    finally:
        log.setLevel(old)
    return coo, key, w, prover, proof, pubs


def test_port_proof_equals_reference_at_k3(proved):
    coo, key, w, prover, proof, pubs = proved
    assert keygen.domain_of(coo) == 1 << 11
    assert prover.coef_slots >= 3
    assert prover.left_s is not None                   # some spilled
    wv = w[:, 0]
    bits = np.concatenate([wv[1:257], wv[257 + 64:]])    # all but bytes
    assert not w[:, 1:].any() and set(np.unique(bits)) == {0, 1}
    ref = Reference(coo, key.toxic, "cpu")
    assert (proof.a, proof.b, proof.c) == ref.proof(w, R, S_)
    assert pubs == [int(v) for v in wv[1:257]]


def test_spans_hold_front_acc_and_the_live_digit_count(proved):
    _, _, w, prover, _, _ = proved
    ph = prover.last_phases
    assert ph["front.acc"] > 0
    live, entries = ph["count.msms.live"], ph["count.msms.entries"]
    assert 0 < live < entries
    # a plain count: the digits of the five MSMs' scalars, nonzero
    wit = torch.from_numpy(np.ascontiguousarray(w).view(np.int32))
    h, wr, c = prover.front(wit, prover.tables())
    nwin = -(-GLV.GLV_BITS // prover.c_bits)
    got_live = got_entries = 0
    for curve, sc in ((G1P, torch.stack([h, wr, wr, c])), (G2P, wr[None])):
        d = MSM.glv_digits(sc, prover.c_bits, 0, nwin,
                           GLV.params_for(curve))
        got_live += int(((d >> 1) != 0).sum())
        got_entries += d.numel()
    assert (live, entries) == (got_live, got_entries)


def test_spans_off_count_nothing():
    sink = {}
    log = L.get_logger()
    old = log.level
    log.setLevel(logging.INFO)
    try:
        with L.collect(sink) as spans:
            assert not L.counting()
            L.count("count.msms.live", torch.ones((), dtype=torch.int64))
            L.count("count.msms.entries", 7)
            spans.read_card()
    finally:
        log.setLevel(old)
    assert sink == {} and spans.counts == {}
