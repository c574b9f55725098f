"""The SHA-256 circuit family: `lanes` independent messages, each hashed
over `steps` chained 512-bit blocks, as circom compiles circomlib's
gadgets with --O1.

Sources:
  * circomlib circuits/sha256/ (sha256compression.circom, xor3.circom,
    ch.circom, maj.circom, sigma.circom, sigmaplus.circom, t1.circom,
    t2.circom, rotate.circom, shift.circom, constants.circom),
    circuits/binsum.circom and circuits/bitify.circom (Num2Bits);
  * zk-email's Sha256Bytes (github.com/zkemail/zk-email-verify,
    packages/circuits): the padded message as bytes, each byte a private
    input split by Num2Bits(8), its bits most significant first into
    Sha256compression, chained over the padded blocks (the fixed-length
    path: no selector for a message shorter than its padding);
  * circom 2's --O1: a signal set to a constant or to a single other
    signal is substituted and gets no row; a product with a constant
    operand folds into a linear combination; every other linear
    constraint stays as a row with A and B empty (C-only).

The gadgets, as circomlib writes them (bits are wires; rotations and
shifts are wiring, ShR's shifted-in bits the constant 0):
  Xor3       mid <== b*c; out <== a*(1 - 2b - 2c + 4mid) + b + c - 2mid
  Ch         out <== a*(b - c) + c
  Maj        mid <== b*c; out <== a*(b + c - 2mid) + mid
  BinSum(n, ops)  nout = bit length of (2^n - 1) ops output bits, each
             out*(out - 1) === 0, then one linear row sum in === sum out
  SmallSigma Xor3(RotR, RotR, ShR); BigSigma Xor3(RotR, RotR, RotR)
  SigmaPlus  BinSum(32, 4) of sigma1(w[t-2]), w[t-7], sigma0(w[t-15]),
             w[t-16]; T1: BinSum(32, 5) of h, Sigma1(e), Ch(e, f, g),
             K_t, w_t; T2: BinSum(32, 2) of Sigma0(a), Maj(a, b, c)
  new e, new a and the 8 sums with hin: BinSum(32, 2), low 32 bits kept
  Num2Bits(8) 8 bit rows out*(out - 1) === 0, one row sum 2^j out_j === in
Block 0's hin is the IV (constants), so its first rounds fold away.

Wires: 0 is the constant one, 1..256 the last lane's digest bits (the
public signals, most significant first, as circomlib's Sha256 exposes
out[256]); then each lane in turn: its 64 steps message bytes, their
bits (8 a byte, least significant first), and each block's gadget wires
in template order, the block's 256 digest bits last. Rows: each lane's
Num2Bits rows (9 a byte), then its blocks'. One block's records are a
template (block 0's and the later blocks' differ), tiled over lanes and
blocks by wire offsets.

Every wire holds a bit or a byte. The witness is computed lane-parallel,
block after block, gadget by gadget, from message bytes drawn from the
seed on the device and padded as SHA-256 pads them. `rounds` (default
64) stops each compression early, for the tests."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..frozen.ref_field import R_FR
from ..keygen import Coo

ROUNDS = 64
N_PUBLIC = 256

IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)
K = (0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
     0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
     0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
     0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
     0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
     0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
     0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
     0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
     0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
     0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
     0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)

# A block template's references: 0 and 1 are the constants 0 and 1 (as a
# key of a linear combination, 1 is the constant wire), then the block's
# 512 input bits, its 256 hin bits, and its own wires
ONE = 1
INP0 = 2
HIN0 = INP0 + 512
OWN0 = HIN0 + 256


def _bits(word: int) -> list:
    """A 32-bit constant as constant references, least significant first."""
    return [(word >> k) & 1 for k in range(32)]


class _Block:
    """One block's rows and witness program, built as circom --O1 emits
    them. A signal is a reference; a linear combination a dict
    {reference: coefficient} whose constant term sits under ONE."""

    def __init__(self):
        self.n_own = 0
        self.rows = []      # (A, B, C) linear combinations
        self.ops = []       # the witness program, in dependency order

    def _new(self) -> int:
        self.n_own += 1
        return OWN0 + self.n_own - 1

    @staticmethod
    def _lc(*terms) -> dict:
        out = {}
        for coef, ref in terms:
            if ref != 0 and coef:
                out[ref] = out.get(ref, 0) + coef
        return {r: v for r, v in out.items() if v}

    @staticmethod
    def _const(lc: dict):
        """The value of a constant combination, else None."""
        return lc.get(ONE, 0) if set(lc) <= {ONE} else None

    def _linear(self, lc: dict) -> int:
        """out <== lc, linear: substituted when lc is a constant or a
        single signal, else a new wire and a C-only row."""
        v = self._const(lc)
        if v is not None:
            if v not in (0, 1):
                raise ValueError(f"sha256: a constant signal {v}")
            return v
        if len(lc) == 1 and next(iter(lc.values())) == 1:
            return next(iter(lc))
        out = self._new()
        self.rows.append(({}, {}, self._lc((1, out), *((-c, r) for r, c
                                                        in lc.items()))))
        return out

    def _assign(self, a: dict, b: dict, lin: dict) -> int:
        """out <== a*b + lin: a row A=a, B=b, C=out - lin, or, with a
        constant operand, the linear out <== k*other + lin."""
        ka, kb = self._const(a), self._const(b)
        if ka is not None or kb is not None:
            k, other = (ka, b) if ka is not None else (kb, a)
            return self._linear(self._lc(*((k * c, r) for r, c in
                                           other.items()),
                                         *((c, r) for r, c in lin.items())))
        out = self._new()
        self.rows.append((a, b, self._lc((1, out), *((-c, r) for r, c
                                                     in lin.items()))))
        return out

    def _op(self, kind: str, ins: tuple, outs: tuple) -> None:
        """Record a gadget's evaluation; only its own wires are written."""
        outs = tuple(np.asarray(o, np.int64) for o in outs)
        if any((o >= OWN0).any() for o in outs):
            self.ops.append((kind, tuple(np.asarray(i, np.int64)
                                         for i in ins), outs))

    def xor3(self, a, b, c) -> list:
        mids, outs = [], []
        for k in range(len(a)):
            mid = self._assign(self._lc((1, b[k])), self._lc((1, c[k])), {})
            out = self._assign(
                self._lc((1, a[k])),
                self._lc((1, ONE), (-2, b[k]), (-2, c[k]), (4, mid)),
                self._lc((1, b[k]), (1, c[k]), (-2, mid)))
            mids.append(mid)
            outs.append(out)
        self._op("xor3", (a, b, c), (mids, outs))
        return outs

    def ch(self, a, b, c) -> list:
        outs = [self._assign(self._lc((1, a[k])),
                             self._lc((1, b[k]), (-1, c[k])),
                             self._lc((1, c[k]))) for k in range(len(a))]
        self._op("ch", (a, b, c), (outs,))
        return outs

    def maj(self, a, b, c) -> list:
        mids, outs = [], []
        for k in range(len(a)):
            mid = self._assign(self._lc((1, b[k])), self._lc((1, c[k])), {})
            out = self._assign(self._lc((1, a[k])),
                               self._lc((1, b[k]), (1, c[k]), (-2, mid)),
                               self._lc((1, mid)))
            mids.append(mid)
            outs.append(out)
        self._op("maj", (a, b, c), (mids, outs))
        return outs

    def binsum(self, ops: list, n: int = 32) -> list:
        nout = (((1 << n) - 1) * len(ops)).bit_length()
        outs = []
        for _ in range(nout):
            o = self._new()
            self.rows.append(({o: 1}, {o: 1, ONE: -1}, {}))
            outs.append(o)
        lin = self._lc(*((1 << k, op[k]) for k in range(n) for op in ops),
                       *((-(1 << k), o) for k, o in enumerate(outs)))
        self.rows.append(({}, {}, lin))
        self._op("binsum", tuple(ops), (outs,))
        return outs

    @staticmethod
    def rotr(x, r):
        return [x[(i + r) % 32] for i in range(32)]

    @staticmethod
    def shr(x, r):
        return [x[i + r] if i + r < 32 else 0 for i in range(32)]

    def small_sigma(self, x, ra, rb, rc):
        return self.xor3(self.rotr(x, ra), self.rotr(x, rb), self.shr(x, rc))

    def big_sigma(self, x, ra, rb, rc):
        return self.xor3(self.rotr(x, ra), self.rotr(x, rb),
                         self.rotr(x, rc))


@dataclass
class _Template:
    """One block's rows as records (m, local row, reference, value
    index), its witness program, its own wires and the own-wire numbers
    of its 256 digest bits (the last 256)."""
    n_rows: int
    n_own: int
    m: np.ndarray
    row: np.ndarray
    ref: np.ndarray
    vidx: np.ndarray
    ops: list
    own_order: np.ndarray     # own wire (creation order) -> local number


def _compression(b: _Block, first: bool, rounds: int) -> list:
    """circomlib's Sha256compression on one block; returns the digest
    references out[0..255]."""
    inp = [INP0 + i for i in range(512)]
    hin = ([bit for word in IV for bit in _bits(word)] if first
           else [HIN0 + i for i in range(256)])
    w = [[inp[t * 32 + 31 - k] for k in range(32)]
         for t in range(min(16, rounds))]
    for t in range(16, rounds):                 # SigmaPlus
        s1 = b.small_sigma(w[t - 2], 17, 19, 10)
        s0 = b.small_sigma(w[t - 15], 7, 18, 3)
        w.append(b.binsum([s1, w[t - 7], s0, w[t - 16]])[:32])
    st = [hin[32 * j:32 * j + 32] for j in range(8)]
    for t in range(rounds):
        a, bb, c, d, e, f, g, h = st
        t1 = b.binsum([h, b.big_sigma(e, 6, 11, 25), b.ch(e, f, g),
                       _bits(K[t]), w[t]])[:32]
        t2 = b.binsum([b.big_sigma(a, 2, 13, 22), b.maj(a, bb, c)])[:32]
        ne = b.binsum([d, t1])[:32]
        na = b.binsum([t1, t2])[:32]
        st = [na, a, bb, c, ne, e, f, g]
    fsum = [b.binsum([hin[32 * j:32 * j + 32], st[j]])[:32]
            for j in range(8)]
    return [fsum[j][31 - m] for j in range(8) for m in range(32)]


_VALUES: dict = {}      # coefficient -> index into the value table


def _vidx(coef: int) -> int:
    return _VALUES.setdefault(coef % R_FR, len(_VALUES))


@functools.lru_cache(maxsize=None)
def _template(first: bool, rounds: int) -> _Template:
    b = _Block()
    digest = _compression(b, first, rounds)
    if len(set(digest)) != N_PUBLIC or min(digest) < OWN0:
        raise AssertionError("sha256: the digest bits are not own wires")
    # number own wires in creation order, the digest bits last in order
    is_digest = np.zeros(b.n_own, bool)
    is_digest[np.asarray(digest) - OWN0] = True
    order = np.empty(b.n_own, np.int64)
    rest = np.nonzero(~is_digest)[0]
    order[rest] = np.arange(rest.size)
    order[np.asarray(digest) - OWN0] = rest.size + np.arange(N_PUBLIC)
    m, row, ref, vidx = [], [], [], []
    for k, abc in enumerate(b.rows):
        for mi, lc in enumerate(abc):
            for r, c in lc.items():
                m.append(mi)
                row.append(k)
                ref.append(r)
                vidx.append(_vidx(c))
    return _Template(len(b.rows), b.n_own, np.asarray(m, np.int8),
                     np.asarray(row, np.int64), np.asarray(ref, np.int64),
                     np.asarray(vidx, np.int32), b.ops, order)


def _value_table() -> np.ndarray:
    vals = sorted(_VALUES, key=_VALUES.get)
    return np.stack([np.frombuffer(v.to_bytes(32, "little"), "<u4")
                     for v in vals])


def _layout(steps: int, rounds: int):
    """(templates a block, each block's own-wire base in its lane, the
    lane's wires, the lane's rows)."""
    tpl = [_template(i == 0, rounds) for i in range(steps)]
    nbytes = 64 * steps
    base, rows = [], 9 * nbytes
    w = 9 * nbytes                              # bytes, then their bits
    for t in tpl:
        base.append(w)
        w += t.n_own
        rows += t.n_rows
    return tpl, base, w, rows


def sizes(lanes: int, steps: int, rounds: int = ROUNDS):
    """(n_vars, n_public, n_constraints)."""
    _, _, wires, rows = _layout(steps, rounds)
    return lanes * wires + 1, N_PUBLIC, lanes * rows


def _lane_records(steps: int, rounds: int):
    """One lane's records as (m, row, wire, value index), sorted by (m,
    row, wire), wire -1 the constant one, on the lane's own numbering."""
    tpl, base, _, _ = _layout(steps, rounds)
    nbytes = 64 * steps
    parts = []
    # Num2Bits(8) a byte: 8 bit rows (A bit, B bit - 1), then
    # sum 2^j bit_j - byte in C
    byte = np.arange(nbytes)
    bit = nbytes + 8 * byte[:, None] + np.arange(8)         # (bytes, 8)
    brow = 9 * byte[:, None] + np.arange(8)
    one, neg1 = _vidx(1), _vidx(-1)
    for m, w, v in ((0, bit, one), (1, bit, one), (1, -1, neg1)):
        parts.append((np.full(bit.size, m), brow.ravel(),
                      np.broadcast_to(w, bit.shape).ravel(),
                      np.full(bit.size, v)))
    pw = np.asarray([_vidx(1 << j) for j in range(8)])
    parts.append((np.full(9 * nbytes, 2),
                  np.repeat(9 * byte + 8, 9),
                  np.concatenate([bit, byte[:, None]], axis=1).ravel(),
                  np.tile(np.append(pw, neg1), nbytes)))
    row0 = 9 * nbytes
    for blk, t in enumerate(tpl):
        mp = np.full(OWN0 + t.n_own, -2, np.int64)
        mp[ONE] = -1
        i = np.arange(512)
        mp[INP0 + i] = nbytes + 8 * (64 * blk + i // 8) + 7 - i % 8
        if blk:
            # hin[32j + k] = the previous block's out[32j + 31 - k]
            prev = tpl[blk - 1]
            j, k = np.arange(256) // 32, np.arange(256) % 32
            mp[HIN0 + np.arange(256)] = (base[blk - 1] + prev.n_own - 256
                                         + 32 * j + 31 - k)
        mp[OWN0:] = base[blk] + t.own_order
        parts.append((t.m, row0 + t.row, mp[t.ref], t.vidx))
        row0 += t.n_rows
    m, row, wire, vidx = (np.concatenate([p[i] for p in parts])
                          for i in range(4))
    order = np.lexsort((wire, row, m))
    return m[order], row[order], wire[order], vidx[order].astype(np.int32)


def coo(lanes: int, steps: int, rounds: int = ROUNDS) -> Coo:
    """The constraint system as COO arrays sorted by (m, k, s)."""
    n_vars, n_public, nc = sizes(lanes, steps, rounds)
    _, _, wl, rl = _layout(steps, rounds)
    m, row, wire, vidx = _lane_records(steps, rounds)
    table = _value_table()
    lane = np.arange(lanes, dtype=np.int64)[:, None]
    out = {"m": [], "k": [], "s": [], "v": []}
    for mi in range(3):
        sel = m == mi
        r, w, v = row[sel], wire[sel], vidx[sel]
        g = 1 + N_PUBLIC + lane * wl + w                    # (lanes, T)
        g = np.where(w < 0, 0, g)
        # the last lane's digest bits, its last 256 wires, are 1..256
        dig = w >= wl - N_PUBLIC
        g[-1] = np.where(dig, 1 + w - (wl - N_PUBLIC), g[-1])
        k = lane * rl + r
        last = np.lexsort((g[-1], k[-1]))
        g[-1], kk, vv = g[-1][last], k[-1][last], v[last]
        out["m"].append(np.full(g.size, mi, np.int64))
        out["k"].append(np.concatenate([k[:-1].ravel(), kk]))
        out["s"].append(g.ravel())
        out["v"].append(np.concatenate([np.broadcast_to(
            v, (lanes - 1, v.size)).ravel(), vv]))
    vidx = np.concatenate(out.pop("v"))
    return Coo(n_vars, n_public, nc, *(np.concatenate(out[c])
                                       for c in ("m", "k", "s")),
               value=table[vidx])


def messages(lanes: int, steps: int, gen: torch.Generator, dev) -> np.ndarray:
    """Each lane's padded message, (lanes, 64 steps) uint8: 64 steps - 9
    bytes drawn from gen on dev, then 0x80 and the 64-bit big-endian bit
    length, as SHA-256 pads a message."""
    n = 64 * steps - 9
    msg = torch.randint(0, 256, (lanes, n), generator=gen,
                        dtype=torch.int64, device=dev).cpu().numpy()
    pad = np.zeros((lanes, 9), np.int64)
    pad[:, 0] = 0x80
    pad[:, 1:] = np.frombuffer((8 * n).to_bytes(8, "big"), np.uint8)
    return np.concatenate([msg, pad], axis=1).astype(np.uint8)


def _run_ops(vals: np.ndarray, ops: list) -> None:
    """A block's witness program over a (references, lanes) value table."""
    pow2 = np.int64(1) << np.arange(32, dtype=np.int64)
    for kind, ins, outs in ops:
        if kind == "binsum":
            tot = sum(pow2 @ vals[i].astype(np.int64) for i in ins)
            got = [(tot[None] >> np.arange(outs[0].size)[:, None]) & 1]
        else:
            a, b, c = (vals[i] for i in ins)
            if kind == "xor3":
                got = [b & c, a ^ b ^ c]
            elif kind == "ch":
                got = [np.where(a == 1, b, c)]
            else:
                got = [b & c, (a & b) | (a & c) | (b & c)]
        for o, v in zip(outs, got):
            own = o >= OWN0
            vals[o[own]] = v[own]


def lane_values(padded: np.ndarray, steps: int,
                rounds: int = ROUNDS) -> np.ndarray:
    """Every lane's wires on its own numbering, (lanes, wires) uint8, from
    the padded messages (lanes, 64 steps), block after block."""
    tpl, base, wl, _ = _layout(steps, rounds)
    lanes, nbytes = padded.shape
    out = np.zeros((lanes, wl), np.uint8)
    out[:, :nbytes] = padded
    bits = (padded[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1
    out[:, nbytes:9 * nbytes] = bits.reshape(lanes, -1)
    hin = None
    for blk, t in enumerate(tpl):
        vals = np.zeros((OWN0 + t.n_own, lanes), np.uint8)
        vals[ONE] = 1
        # the block's input bits, each byte's most significant first
        vals[INP0:HIN0] = bits[:, 64 * blk:64 * blk + 64, ::-1].reshape(
            lanes, 512).T
        if blk:
            j, k = np.arange(256) // 32, np.arange(256) % 32
            vals[HIN0:OWN0] = hin[32 * j + 31 - k]
        _run_ops(vals, t.ops)
        own = np.empty((t.n_own, lanes), np.uint8)
        own[t.own_order] = vals[OWN0:]
        out[:, base[blk]:base[blk] + t.n_own] = own.T
        hin = own[-N_PUBLIC:]                   # out[0..255]
    return out


def chain(lanes: int, steps: int, padded: np.ndarray,
          rounds: int = ROUNDS) -> np.ndarray:
    """The witness of the padded messages: (n_vars, 8) uint32
    standard-form words, the wtns layout."""
    n_vars, _, _ = sizes(lanes, steps, rounds)
    flat = lane_values(padded, steps, rounds).reshape(-1)
    out = np.zeros((n_vars, 8), np.uint32)
    out[0, 0] = 1
    # lane wires in order from 257; the last lane's digest is wires 1..256
    out[1:1 + N_PUBLIC, 0] = flat[-N_PUBLIC:]
    out[1 + N_PUBLIC:, 0] = flat[:-N_PUBLIC]
    return out


def witness(lanes: int, steps: int, gen: torch.Generator, dev,
            rounds: int = ROUNDS) -> np.ndarray:
    """One witness: the lanes' messages drawn from gen on dev, padded,
    then hashed."""
    return chain(lanes, steps, messages(lanes, steps, gen, dev), rounds)
