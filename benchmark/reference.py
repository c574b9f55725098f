"""The plain reference: what each proof has to be.

It imports nothing of the port and takes nothing the port made: only the
constraint system, the toxic waste, the witnesses and the blinding (r, s)
that the benchmark made and handed the port too.

With the toxic waste (tau, alpha, beta, gamma, delta) known, a Groth16
proof is known in the exponent:
    a = alpha + sum_i w_i u_i(tau) + r delta,   A = [a] G1
    b = beta  + sum_i w_i v_i(tau) + s delta,   B = [b] G2
    c = (a b - alpha beta - sum_{i <= n_public} w_i (beta u_i + alpha v_i
         + w_i)(tau)) / delta,                  C = [c] G1
(the last by the verification equation, which holds for the one valid C
given A and B). sum_i w_i u_i(tau) = sum_k L_k(tau) (A w)_k: the rows of
the extended A times the witness, weighted by the domain's Lagrange
values at tau. So the reference is two row products and two weighted
sums a witness on plain torch limbs (fieldvec), and three scalar
multiplications a proof on the host by affine double-and-add
(frozen/ref_curve, the port's test oracle, not the group law of its
host assembly) — far from the MSMs it checks, and exact: the proof has
to match point for point.

Where (r, s) is not known (the CLI draws its own), `verify` checks a proof
by the pairing equation against the verifying key (frozen/pairing)."""

from __future__ import annotations

import numpy as np
import torch

from . import fieldvec as V
from .frozen import field as FF
from .frozen import pairing
from .frozen.ref_curve import G1, G1_GEN, G2, G2_GEN
from .frozen.ref_field import R_FR
from .keygen import Coo, domain_of, lagrange, with_public_rows


def publics(witness: np.ndarray, n_public: int) -> list:
    """The public signals (wires 1..n_public) of a words witness."""
    return [int.from_bytes(np.ascontiguousarray(witness[i], "<u4")
                           .tobytes(), "little")
            for i in range(1, n_public + 1)]


class Reference:
    """Expected proofs of one constraint system under one toxic waste."""

    def __init__(self, coo: Coo, toxic: tuple, dev):
        self.coo = with_public_rows(coo)
        self.n_public = coo.n_public
        self.toxic = toxic
        self.dev = torch.device(dev)
        self.domain = domain_of(coo)
        self._lag = None
        self._sums = {}

    def _lagrange(self):
        if self._lag is None:
            self._lag = lagrange(self.domain, self.toxic[0], self.dev)
        return self._lag

    def _weighted(self, w: torch.Tensor, m: int, public_only: bool) -> int:
        """sum_k L_k(tau) (M w)_k for matrix m (0 / 1 / 2 = A / B / C),
        over the public wires' entries only when asked."""
        c = self.coo
        sel = c.m == m
        if public_only:
            sel &= c.s <= self.n_public
        idx = np.nonzero(sel)[0]
        if idx.size == 0:
            return 0
        dev = self.dev
        rows = V.accumulate(w, torch.from_numpy(c.s[idx]).to(dev),
                            V.words_t(c.value[idx], dev),
                            torch.from_numpy(c.k[idx]).to(dev), self.domain)
        return V.dot(self._lagrange(), rows)

    def sums(self, witness: np.ndarray) -> tuple:
        """(sum w u(tau), sum w v(tau), the public part) of a witness."""
        # by identity: a cell proves a few witness arrays many times, and
        # hashing a 2^24 witness's 512 MB took ~0.7 s a proof
        key = id(witness)
        if key not in self._sums:
            _, alpha, beta, _, _ = self.toxic
            w = FF.unpack(V.words_t(witness, self.dev))
            pub = (beta * self._weighted(w, 0, True)
                   + alpha * self._weighted(w, 1, True)
                   + self._weighted(w, 2, True)) % R_FR
            self._sums[key] = (witness, (self._weighted(w, 0, False),
                                         self._weighted(w, 1, False), pub))
        return self._sums[key][1]

    def proof(self, witness: np.ndarray, r: int, s: int) -> tuple:
        """The proof (A, B, C) as affine ints, B as Fq2 pairs."""
        _, alpha, beta, _, delta = self.toxic
        au, bv, pub = self.sums(witness)
        a = (alpha + au + r * delta) % R_FR
        b = (beta + bv + s * delta) % R_FR
        c = ((a * b - alpha * beta - pub) * pow(delta, -1, R_FR)) % R_FR
        return G1.mul(G1_GEN, a), G2.mul(G2_GEN, b), G1.mul(G1_GEN, c)

    def free(self) -> None:
        self._lag = None


def verify(vk: dict, ic: list, proof: tuple, pubs: list) -> bool:
    """Groth16's pairing check of proof (A, B, C) for the public signals
    pubs: e(-A, B) e(alpha, beta) e(vk_x, gamma) e(C, delta) = 1, vk_x =
    IC_0 + sum_i pubs_i IC_i (ic: affine ints)."""
    vk_x = ic[0]
    for i, v in enumerate(pubs):
        vk_x = G1.add(vk_x, G1.mul(ic[i + 1], v))
    a, b, c = proof
    return pairing.pairing_product_is_one([
        (G1.neg(a), b), (vk["alpha1"], vk["beta2"]),
        (vk_x, vk["gamma2"]), (c, vk["delta2"])])
