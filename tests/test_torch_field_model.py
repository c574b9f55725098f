"""A Python-int model of the CUDA kernels' Montgomery product
(rapidsnark_tpu_torch/csrc/field.cuh `mont`) and of its reduction of a sum
of two products (`mont2`), instruction by instruction in the order the
kernel issues them, held word for word against the plain products of
rapidsnark_tpu_torch/ops/field.py (Fq and Fr) and against
(a*b + m*p) / R, (a*b + c*d + m*p) / R computed with Python integers.

The model runs each PTX instruction on 32-bit words with one carry flag
and asserts that no instruction the kernel issues without a carry out
(`madc.hi.u32`, `addc.u32`) ever wraps: the frames' bound argument of
field.cuh, checked on every input here. Inputs: seeded random canonical
values, the edge values 0, 1, p - 1, and relaxed values up to 2p (the G1
law feeds products in [0, 2p]; `mont2` takes canonical values, its last
operand up to p). Tolerance: exact words."""

import numpy as np
import pytest
import torch

from rapidsnark_tpu_torch.ops import field as FF
from rapidsnark_tpu_torch.ref.field import P, R_FR

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
R = 1 << 256
FIELDS = {"fq": (P, FF.FQ), "fr": (R_FR, FF.FR)}


class Chain:
    """PTX integer instructions on u32 words with the carry flag CC.CF."""

    def __init__(self):
        self.cf = 0

    def _out(self, v, cc):
        if cc:
            self.cf = v >> 32
        else:
            assert v >> 32 == 0, "an instruction without .cc wrapped"
        return v & M32

    def add(self, a, b, cc=True, carry_in=False):       # add[c].cc.u32
        return self._out(a + b + (self.cf if carry_in else 0), cc)

    def mad_lo(self, a, b, c, cc=True, carry_in=False):  # mad[c].lo[.cc]
        return self._out(((a * b) & M32) + c + (self.cf if carry_in else 0),
                         cc)

    def mad_hi(self, a, b, c, cc=True, carry_in=True):   # mad[c].hi[.cc]
        return self._out(((a * b) >> 32) + c + (self.cf if carry_in else 0),
                         cc)


def words(v):
    return [(v >> (32 * i)) & M32 for i in range(8)]


def value(w):
    return sum(x << (32 * i) for i, x in enumerate(w))


def csub(s, k):
    return s - k if s >= k else s


def mul_row(a, b, odd):
    """mul_row<O>: lo, hi of a[2k+O] * b at words 2k, 2k+1."""
    x = [0] * 8
    for k in range(4):
        x[2 * k] = (a[2 * k + odd] * b) & M32
        x[2 * k + 1] = (a[2 * k + odd] * b) >> 32
    return x


def mad_row(y, top, w, b, odd):
    """mad_row<O>: y += w[2k+O] * b, the carry onto top; returns top."""
    c = Chain()
    for k in range(4):
        y[2 * k] = c.mad_lo(w[2 * k + odd], b, y[2 * k], carry_in=k > 0)
        y[2 * k + 1] = c.mad_hi(w[2 * k + odd], b, y[2 * k + 1])
    return c.add(top, 0, cc=False, carry_in=True)


def mad_row_odd(x, w, b):
    """mad_row_odd: x += w[2k+1] * b, no carry out."""
    c = Chain()
    for k in range(4):
        x[2 * k] = c.mad_lo(w[2 * k + 1], b, x[2 * k], carry_in=k > 0)
        x[2 * k + 1] = c.mad_hi(w[2 * k + 1], b, x[2 * k + 1], cc=k < 3)


def shift_row_odd(x, y, a, b):
    """shift_row_odd: y[0] += x[1]; x = x[2..7] + a[2k+1] * b."""
    c = Chain()
    y[0] = c.add(y[0], x[1])
    src = x[2:] + [0, 0]
    for k in range(4):
        x[2 * k] = c.mad_lo(a[2 * k + 1], b, src[2 * k], carry_in=True)
        x[2 * k + 1] = c.mad_hi(a[2 * k + 1], b, src[2 * k + 1], cc=k < 3)


def redc_row(y, x, p, n0):
    m = (y[0] * n0) & M32
    mad_row_odd(x, p, m)
    x[7] = mad_row(y, x[7], p, m, 0)
    assert y[0] == 0


def mont_round(x, y, a, b, p, n0):
    shift_row_odd(x, y, a, b)
    x[7] = mad_row(y, x[7], a, b, 0)
    redc_row(y, x, p, n0)


def merge_frames(e, o):
    """r = e + (o >> 32): o the zero frame, e the odd one."""
    c = Chain()
    r = [c.add(e[j], o[j + 1], carry_in=j > 0) for j in range(7)]
    r.append(c.add(e[7], 0, cc=False, carry_in=True))
    return r


def n0inv(mod):
    return (-pow(mod, -1, 1 << 32)) % (1 << 32)


def mont_model(av, bv, mod):
    """field.cuh `mont` on integers: (a*b + m*p) / R as 8 words."""
    a, b, p, n0 = words(av), words(bv), words(mod), n0inv(mod)
    e, o = mul_row(a, b[0], 0), mul_row(a, b[0], 1)
    redc_row(e, o, p, n0)
    for i in range(1, 8, 2):
        mont_round(e, o, a, b[i], p, n0)
        if i + 1 < 8:
            mont_round(o, e, a, b[i + 1], p, n0)
    return merge_frames(e, o)


def mont2_round(x, y, a, b, c, d, p, n0):
    shift_row_odd(x, y, a, b)
    x[7] = mad_row(y, x[7], a, b, 0)
    mad_row_odd(x, c, d)
    x[7] = mad_row(y, x[7], c, d, 0)
    redc_row(y, x, p, n0)


def mont2_model(av, bv, cv, dv, mod):
    """field.cuh `mont2` before its conditional subtraction:
    (a*b + c*d + m*p) / R as 8 words."""
    a, b, c, d = (words(v) for v in (av, bv, cv, dv))
    p, n0 = words(mod), n0inv(mod)
    e, o = mul_row(a, b[0], 0), mul_row(a, b[0], 1)
    mad_row_odd(o, c, d[0])
    o[7] = mad_row(e, o[7], c, d[0], 0)
    redc_row(e, o, p, n0)
    for i in range(1, 8, 2):
        mont2_round(e, o, a, b[i], c, d[i], p, n0)
        if i + 1 < 8:
            mont2_round(o, e, a, b[i + 1], c, d[i + 1], p, n0)
    return merge_frames(e, o)


def f_mul_model(av, bv, mod):
    """f_mul: the product, then one conditional subtraction of p."""
    t = value(mont_model(av, bv, mod))
    return words(t - mod if t >= mod else t)


def inputs(kind, mod, seed):
    rs = np.random.RandomState(seed)
    if kind == "edge":
        vals = [0, 1, mod - 1, 2, mod - 2, (1 << 255) % mod, R % mod]
        return [(x, y) for x in vals for y in vals]
    top = 2 * mod if kind == "relaxed" else mod
    out = []
    for _ in range(48):
        w = rs.randint(0, 1 << 32, size=(2, 9), dtype=np.uint64)
        x, y = (sum(int(v) << (32 * i) for i, v in enumerate(row)) % top
                for row in w)
        out.append((x, y))
    if kind == "relaxed":
        out += [(2 * mod, 2 * mod), (2 * mod, mod - 1), (2 * mod - 1, 1)]
    return out


def plain_mul(ops, pairs, cond_sub):
    """ops/field.py's product on the same values, as 8 words each."""
    a = torch.tensor(np.array([words(x) for x, _ in pairs], dtype=np.uint32)
                     .view(np.int32))
    b = torch.tensor(np.array([words(y) for _, y in pairs], dtype=np.uint32)
                     .view(np.int32))
    out = FF.pack(ops.mul(FF.unpack(a), FF.unpack(b), cond_sub=cond_sub))
    return [list(r) for r in out.numpy().view(np.uint32).astype(int)]


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("kind", ["random", "edge", "relaxed"])
def test_mont_schedule_matches_plain_product(field, kind):
    mod, ops = FIELDS[field]
    pairs = inputs(kind, mod, seed=len(kind) + (7 if field == "fr" else 0))
    got = [mont_model(x, y, mod) for x, y in pairs]
    assert got == plain_mul(ops, pairs, cond_sub=False)
    rinv = pow(R, -1, mod)
    for (x, y), w in zip(pairs, got):
        m = (-x * y * pow(mod, -1, R)) % R
        t = (x * y + m * mod) // R
        assert value(w) == t and t % mod == x * y * rinv % mod
        assert t < 2 * mod
    if kind != "relaxed":            # f_mul: canonical inputs or lazy sums
        want = plain_mul(ops, pairs, cond_sub=True)
        assert [f_mul_model(x, y, mod) for x, y in pairs] == want


def mont2_inputs(kind, mod, seed):
    """Quadruples (a, b, c, d): seeded random canonical values, or 0, 1
    and p - 1 in every position (all four at p - 1 among them), and d = p,
    the operand p - b1 that s_mul hands mont2 for a partner component
    b1 = 0."""
    if kind == "edge":
        vals = [0, 1, mod - 1]
        out = [(a, b, c, d) for a in vals for b in vals for c in vals
               for d in vals]
        return out + [(x, y, mod - 1, mod) for x in vals for y in vals]
    rs = np.random.RandomState(seed)
    w = rs.randint(0, 1 << 32, size=(48, 4, 9), dtype=np.uint64)
    return [tuple(sum(int(v) << (32 * i) for i, v in enumerate(row)) % mod
                  for row in quad) for quad in w]


def plain_mul2(ops, quads):
    """ops/field.py's canonical a*b + c*d, as 8 words each."""
    def col(j):
        return FF.unpack(torch.tensor(np.array(
            [words(q[j]) for q in quads], dtype=np.uint32).view(np.int32)))
    out = FF.pack(ops.add(ops.mul(col(0), col(1)), ops.mul(col(2), col(3))))
    return [list(r) for r in out.numpy().view(np.uint32).astype(int)]


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("kind", ["random", "edge"])
def test_mont2_schedule_matches_plain_sum_of_products(field, kind):
    mod, ops = FIELDS[field]
    quads = mont2_inputs(kind, mod, seed=11 + (7 if field == "fr" else 0))
    got = [mont2_model(*q, mod) for q in quads]
    rinv = pow(R, -1, mod)
    for (a, b, c, d), w in zip(quads, got):
        s = a * b + c * d
        m = (-s * pow(mod, -1, R)) % R
        t = (s + m * mod) // R
        assert value(w) == t and t < 2 * mod
        assert csub(t, mod) == s * rinv % mod
    canon = [words(csub(value(w), mod)) for w in got]
    assert canon == plain_mul2(ops, quads)


# ---------------------------------------------------------------------------
# The adders' schedules (rapidsnark_tpu_torch/csrc/curve.cu), op for op on
# Python integers with the product above, against the plain group laws:
# G1's relaxed [0, 2p] law as one thread a lane runs it, and the G2
# laws (the iso-twist's, and the strict law on the zkey's twist) as two
# threads a lane run them (thread c holds component c of every Fq2
# value; `xchg` is what __shfl_xor_sync(.., 1) hands each thread of the
# pair). Exact words on all.

from rapidsnark_tpu_torch.ops import fused as TFU               # noqa: E402
from rapidsnark_tpu_torch.ops.curve import G1P, G2P, G2P_ISO    # noqa: E402

P2 = 2 * P
C9 = 9 * R % P                 # K_C9: Montgomery form of 9


def mont(a, b):
    return value(mont_model(a, b, P))


def mont2(a, b, c, d):
    """field.cuh `mont2`: canonical (a*b + c*d) R^-1."""
    return csub(value(mont2_model(a, b, c, d, P)), P)


def add_rx(a, b):
    return csub((a + b) % R, P2)


def sub_rx(a, b):
    return csub(((a - b) % R + P2) % R, P2)


def triple_rx(a):
    return csub((2 * a % R + a) % R, P2)


def f_add(a, b):
    return csub((a + b) % R, P)


def f_sub(a, b):
    d = (a - b) % R
    return (d + P) % R if a < b else d


def g1_add_rx(p, q):
    """k_add_g1: the RCB complete add, relaxed."""
    (px, py, pz), (qx, qy, qz) = p, q
    t0, t1, t2 = mont(px, qx), mont(py, qy), mont(pz, qz)
    t3 = add_rx(mont(px, qy), mont(py, qx))
    t4 = add_rx(mont(py, qz), mont(pz, qy))
    t5 = add_rx(mont(px, qz), mont(pz, qx))
    t2b, y3b = mont(t2, C9), mont(t5, C9)
    t0_3 = triple_rx(t0)
    z3, t1m = add_rx(t1, t2b), sub_rx(t1, t2b)
    return (sub_rx(mont(t3, t1m), mont(t4, y3b)),
            add_rx(mont(t1m, z3), mont(y3b, t0_3)),
            add_rx(mont(z3, t4), mont(t0_3, t3)))


def g1_add_mixed_rx(p, x2, y2):
    """k_scan_g1's step: projective + affine (x2, y2) != (0,0)."""
    px, py, pz = p
    t0, t1 = mont(px, x2), mont(py, y2)
    t3 = add_rx(mont(px, y2), mont(py, x2))
    t4 = add_rx(mont(y2, pz), py)
    y3l = add_rx(mont(x2, pz), px)
    t2b = mont(pz, C9)
    t0_3 = triple_rx(t0)
    y3b = mont(y3l, C9)
    z3, t1m = add_rx(t1, t2b), sub_rx(t1, t2b)
    return (sub_rx(mont(t3, t1m), mont(t4, y3b)),
            add_rx(mont(t1m, z3), mont(y3b, t0_3)),
            add_rx(mont(z3, t4), mont(t0_3, t3)))


def xchg(v):
    return [v[1], v[0]]


def lin(fn, *vals):
    """A linear Fq2 op: each thread on its own component."""
    return [fn(*(v[c] for v in vals)) for c in (0, 1)]


def s_mul(a, b):
    """s_mul: thread c gets the partner's components of a and b and
    reduces, c = 0: a0b0 + a1(p - b1) (p for b1 = 0), c = 1: a1b0 + a0b1,
    one mont2 a thread."""
    ao, bo = xchg(a), xchg(b)
    out = []
    for c in (0, 1):
        u, v = (bo[c], b[c]) if c else (b[c], P - bo[c])
        out.append(mont2(a[c], u, ao[c], v))
    return out


def s_mul_b3(t):
    """(3 + 27i) t: thread c gets the partner's 27 t."""
    s3 = lin(lambda x: f_add(f_add(x, x), x), t)
    s27 = lin(lambda x: f_add(
        f_add(f_add(f_add(x, x), f_add(x, x)),
              f_add(f_add(x, x), f_add(x, x))), x), s3)
    so = xchg(s27)
    return [f_add(so[1], s3[1]) if c else f_sub(s3[0], so[0])
            for c in (0, 1)]


def s_add(p, q):
    """k_add_g2s: the complete add on the iso-twist, two threads a lane."""
    (px, py, pz), (qx, qy, qz) = p, q
    t0, t1, t2 = s_mul(px, qx), s_mul(py, qy), s_mul(pz, qz)
    t3 = lin(f_sub, lin(f_sub, s_mul(lin(f_add, px, py), lin(f_add, qx, qy)),
                        t0), t1)
    t4 = lin(f_sub, lin(f_sub, s_mul(lin(f_add, py, pz), lin(f_add, qy, qz)),
                        t1), t2)
    t5 = lin(f_sub, lin(f_sub, s_mul(lin(f_add, px, pz), lin(f_add, qx, qz)),
                        t0), t2)
    return _s_tail(t0, t1, t3, t4, s_mul_b3(t2), s_mul_b3(t5))


def s_mul_b3_twist(t):
    """b3 * t on the zkey's twist, b3 = (B0, B1) = 9/(9+i): thread c gets
    the partner's component of t and holds B0, and B1 (c = 1) or p - B1
    (c = 0, K_B3_G2_NEG1)."""
    to, (b0, b1) = xchg(t), G2P.b3_mont
    return [mont2(t[c], b0, to[c], b1 if c else P - b1) for c in (0, 1)]


def s_add_mixed(p, x2, y2, b3=s_mul_b3):
    """k_scan_g2's step (b3 = 3 + 27i on the iso-twist) and, with
    s_mul_b3_twist, k_add_mixed_g2's strict law: projective + affine
    (x2, y2) != (0,0)."""
    px, py, pz = p
    t0, t1 = s_mul(px, x2), s_mul(py, y2)
    t3 = lin(f_sub, lin(f_sub, s_mul(lin(f_add, px, py), lin(f_add, x2, y2)),
                        t0), t1)
    t4 = lin(f_add, s_mul(y2, pz), py)
    y3l = lin(f_add, s_mul(x2, pz), px)
    return _s_tail(t0, t1, t3, t4, b3(pz), b3(y3l))


def _s_tail(t0, t1, t3, t4, t2b, y3b):
    t0_3 = lin(f_add, lin(f_add, t0, t0), t0)
    z3, t1m = lin(f_add, t1, t2b), lin(f_sub, t1, t2b)
    return (lin(f_sub, s_mul(t3, t1m), s_mul(t4, y3b)),
            lin(f_add, s_mul(t1m, z3), s_mul(y3b, t0_3)),
            lin(f_add, s_mul(z3, t4), s_mul(t0_3, t3)))


def to_ints(t):
    """(..., 8) int32 words -> nested lists of ints."""
    w = t.numpy().view(np.uint32).astype(object)
    return np.vectorize(lambda *ws: value(list(ws)), otypes=[object])(
        *[w[..., i] for i in range(8)]).tolist()


def to_words(vals):
    return torch.from_numpy(np.array(
        [[words(v) for v in row] for row in vals], dtype=np.uint32)
        .view(np.int32))


def coords(row, g2):
    """A lane's list of coordinate ints -> the model's point."""
    return ([row[0:2], row[2:4], row[4:6]] if g2 else row)


def flat(pt, g2):
    return [v for c in pt for v in c] if g2 else list(pt)


def rand_words(shape, seed):
    rs = np.random.RandomState(seed)
    w = rs.randint(0, 1 << 32, size=tuple(shape) + (8,), dtype=np.uint64)
    w[..., 7] %= P >> 224
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("g2", [False, True])
def test_add_schedule_matches_plain_add(g2):
    """Random points, q = p, q = -p, p or q at infinity ((0, 1, 0))."""
    L, n = (6 if g2 else 3), 10
    p, q = rand_words((n, L), 31), rand_words((n, L), 32)
    one = torch.tensor(np.array(words(R % P), np.uint32).view(np.int32))
    y = slice(L // 3, 2 * L // 3)
    q[2], q[3] = p[2], p[3]
    q[3, y] = FF.pack(FF.FQ.neg(FF.unpack(p[3, y])))           # q = -p
    for t, lane in ((p, 4), (q, 5)):
        t[lane] = 0
        t[lane, L // 3] = one
    curve = G2P_ISO if g2 else G1P
    law = s_add if g2 else g1_add_rx
    got = to_words([flat(law(coords(a, g2), coords(b, g2)), g2)
                    for a, b in zip(to_ints(p), to_ints(q))])
    assert torch.equal(got, TFU.add_plain(curve, p, q))


@pytest.mark.parametrize("g2", [False, True])
def test_scan_schedule_matches_plain_scan(g2):
    """K = 3 columns over 5 lanes with (0,0) entries, an empty column and
    signs set."""
    L, n, K = (6 if g2 else 3), 5, 3
    A = L - L // 3
    acc, cols = rand_words((n, L), 33), rand_words((K, n, A), 34)
    cols[:, ::3] = 0
    cols[1] = 0
    sign = torch.from_numpy(np.random.RandomState(35).randint(
        0, 2, size=(K, n)).astype(np.int32))
    step = ((lambda a, x, y: s_add_mixed(a, x, y)) if g2
            else (lambda a, x, y: g1_add_mixed_rx(a, x, y)))
    neg = (lambda y: lin(f_sub, [0, 0], y)) if g2 else (lambda y: f_sub(0, y))
    ci, si = to_ints(cols), sign.numpy()
    out = [[None] * n for _ in range(K)]
    for i, row in enumerate(to_ints(acc)):
        a = coords(row, g2)
        for k in range(K):
            x2, y2 = ((ci[k][i][0:2], ci[k][i][2:4]) if g2
                      else tuple(ci[k][i]))
            if any(flat([x2, y2], g2) if g2 else (x2, y2)):
                a = step(a, x2, neg(y2) if si[k, i] else y2)
            out[k][i] = flat(a, g2)
    got = torch.stack([to_words(rows) for rows in out])
    want = TFU.scan_cols_plain(G2P_ISO if g2 else G1P, acc, cols, sign)
    assert torch.equal(got, want)


def test_scan_add_imads_counts_the_scan_schedules(monkeypatch):
    """tools.scan_add_imads, the mixed add's multiply-adds behind
    chip_smoke.py's scan bound: the products the scans' steps above make
    (k_scan_g1's 14 Montgomery products; k_scan_g2's 11 Fq2 products,
    counted as 33), at MONT_IMADS (264) each."""
    from rapidsnark_tpu_torch import tools
    calls = {"mont": 0, "s_mul": 0}
    for name in calls:
        real = globals()[name]

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setitem(globals(), name, counted)
    rs = np.random.RandomState(38)
    v = [int(rs.randint(1, 1 << 30)) * 7919 % P for _ in range(12)]
    g1_add_mixed_rx(v[0:3], v[3], v[4])
    s_add_mixed([v[0:2], v[2:4], v[4:6]], v[6:8], v[8:10])
    assert (calls["mont"], calls["s_mul"]) == (14, 11)
    assert tools.MONT_IMADS == 264
    assert tools.scan_add_imads("g1") == calls["mont"] * tools.MONT_IMADS
    assert tools.scan_add_imads("g2") == \
        3 * calls["s_mul"] * tools.MONT_IMADS


def test_strict_mixed_schedule_matches_plain_add_mixed():
    """k_add_mixed_g2 (both forms of its operand share the law): random
    lanes, (0,0) lanes (the kernel keeps p), q = p and q = -p (z = 1)."""
    n = 8
    p, q = rand_words((n, 6), 36), rand_words((n, 4), 37)
    one = torch.tensor(np.array(words(R % P), np.uint32).view(np.int32))
    q[1] = 0
    for lane in (2, 3):
        p[lane, 4:] = 0
        p[lane, 4] = one
        p[lane, :4] = q[lane]
    q[3, 2:] = FF.pack(FF.FQ.neg(FF.unpack(q[3, 2:])))          # q = -p
    out = []
    for a, b in zip(to_ints(p), to_ints(q)):
        pt = coords(a, True)
        out.append(flat(pt, True) if not any(b) else flat(
            s_add_mixed(pt, b[0:2], b[2:4], b3=s_mul_b3_twist), True))
    assert torch.equal(to_words(out), TFU.add_mixed_packed_plain(G2P, p, q))


def test_b3_twist_constants_match_the_curve():
    """field.cuh's K_B3_G2 (B0, B1) and K_B3_G2_NEG1 (p - B1), which the
    strict law's product by b3 reads, against ops/curve.py's b3."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(TFU.__file__), os.pardir,
                            "csrc", "field.cuh")).read()

    def const(name):
        body = re.search(name + r"(?:\[\d+\])+ = \{(.*?)\};", src, re.S)
        return [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)u",
                                               body.group(1))]
    b0, b1 = G2P.b3_mont
    b3 = const("K_B3_G2")
    assert [value(b3[:8]), value(b3[8:])] == [b0, b1]
    assert value(const("K_B3_G2_NEG1")) == P - b1
