"""Port curve ops and the two curve kernels' plain versions vs the JAX
package (the CUDA kernels are held against these plain versions in
test_torch_kernels.py).

Tolerances: exact words against the JAX formulas (the same op sequence
gives the same words, relaxed G1 included); group equality after affine
normalization against the pure-Python oracle.
"""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rapidsnark_tpu.ops import curve as JC
from rapidsnark_tpu.ops import fused as JFU
from rapidsnark_tpu.ref import curve as refc
from rapidsnark_tpu.ref.field import P, R_FR
from rapidsnark_tpu_torch.ops import curve as TC
from rapidsnark_tpu_torch.ops import field as TF
from rapidsnark_tpu_torch.ops import fused as TFU
from rapidsnark_tpu_torch.utils import points as TPT

from test_torch_field import limbs, rand_vals, same, to_t

N = 32


def _elem(g2, seed, bound=1.0):
    if g2:
        return (limbs(rand_vals(P, N, bound, seed)),
                limbs(rand_vals(P, N, bound, seed + 1000)))
    return limbs(rand_vals(P, N, bound, seed))


def _pt(g2, seed, ncoords=3, bound=1.0):
    return tuple(_elem(g2, seed + 10 * k, bound) for k in range(ncoords))


def _map(pt, fn):
    return tuple(_map(c, fn) if isinstance(c, tuple) else fn(c) for c in pt)


def _leaves(pt):
    out = []
    for c in pt:
        out.extend(_leaves(c) if isinstance(c, tuple) else [c])
    return out


def _packed(pt) -> torch.Tensor:
    """JAX-layout limb point -> port packed (n, L, 8) int32."""
    return TC.pack_point(_map(pt, to_t))


CASES = [("G1P", "add"), ("G1P", "add_mixed"), ("G1P", "add_rx"),
         ("G1P", "add_mixed_rx"), ("G2P", "add"), ("G2P", "add_mixed"),
         ("G2P_ISO", "add"), ("G2P_ISO", "add_mixed")]


@pytest.mark.parametrize("curve,op", CASES)
def test_group_law_matches_jax(curve, op):
    g2 = curve != "G1P"
    bound = 2.0 if op.endswith("_rx") and op != "add_mixed_rx" else 1.0
    p = _pt(g2, 1, 3, bound)
    q = _pt(g2, 2, 2 if "mixed" in op else 3,
            1.0 if "mixed" in op else bound)
    want = jax.jit(getattr(getattr(JC, curve), op))(
        _map(p, jnp.asarray), _map(q, jnp.asarray))
    got = getattr(getattr(TC, curve), op)(_map(p, to_t), _map(q, to_t))
    for g, w in zip(_leaves(got), _leaves(want)):
        assert same(g, w)


def _adversarial(group, gen, n=6, seed=11):
    rng = random.Random(seed)
    ps = [group.mul(gen, rng.randrange(1, R_FR)) for _ in range(n)]
    qs = [group.mul(gen, rng.randrange(1, R_FR)) for _ in range(n)]
    ps[0] = qs[0]                 # doubling
    qs[1] = group.neg(ps[1])      # cancellation
    qs[2] = None                  # + infinity
    ps[3] = None
    return ps, qs


def _to_affine_port(curve, pts, g2):
    arr = np.stack([(TPT.g2_affine_to_mont_limbs if g2
                     else TPT.g1_affine_to_mont_limbs)(p) for p in pts])
    cs = [torch.from_numpy(arr[:, k].T.astype(np.int64))
          for k in range(arr.shape[1])]
    return ((cs[0], cs[1]), (cs[2], cs[3])) if g2 else (cs[0], cs[1])


def _word_limbs(w):
    """(8,) u32 words -> (16,) 16-bit limbs."""
    return np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(16)


def _host(pt, g2):
    out = []
    words = [TF.pack(e).numpy().view(np.uint32) for e in _leaves(pt)]
    n = words[0].shape[0]
    for i in range(n):
        w = [_word_limbs(x[i]) for x in words]
        if g2:
            out.append(TPT.proj_to_affine_g2((w[0], w[1]), (w[2], w[3]),
                                             (w[4], w[5])))
        else:
            out.append(TPT.proj_to_affine_g1(w[0], w[1], w[2]))
    return out


@pytest.mark.parametrize("g2", [False, True])
def test_group_law_vs_oracle(g2):
    """Complete adds on doubling / cancellation / infinity lanes agree
    with the ref group law after affine normalization."""
    group, gen = (refc.G2, refc.G2_GEN) if g2 else (refc.G1, refc.G1_GEN)
    curve = TC.G2P if g2 else TC.G1P
    ps, qs = _adversarial(group, gen)
    pa, qa = _to_affine_port(curve, ps, g2), _to_affine_port(curve, qs, g2)
    P_, Q_ = curve.from_affine(*pa), curve.from_affine(*qa)
    adds = [curve.add(P_, Q_), curve.add_mixed(P_, qa)]
    if not g2:
        adds.append(curve.add_rx(P_, Q_))
        adds.append(curve.add_mixed_rx(P_, qa))
    for got in adds:
        for g, p, q in zip(_host(got, g2), ps, qs):
            e = group.add(p, q)
            assert (g is None and e is None) or group.eq(g, e)


@pytest.mark.parametrize("curve", ["G1P", "G2P_ISO"])
def test_plain_add_matches_jax_fused(curve):
    """ops/fused.add plain version vs the JAX package's fused.add (its
    plain XLA reference on the CPU)."""
    g2 = curve != "G1P"
    p, q = _pt(g2, 3, 3, 2.0 if not g2 else 1.0), _pt(g2, 4, 3,
                                                      2.0 if not g2 else 1.0)
    want = JFU.add(getattr(JC, curve), _map(p, jnp.asarray),
                   _map(q, jnp.asarray))
    got = TFU.add(getattr(TC, curve), _packed(p), _packed(q))
    assert torch.equal(got, _packed(_map(want, np.asarray)))


@pytest.mark.parametrize("curve", ["G1P", "G2P_ISO"])
def test_plain_scan_matches_jax_fused(curve):
    """scan_cols_packed plain version vs the JAX package's (K = 3 columns,
    signs set, one infinity column lane)."""
    from rapidsnark_tpu.ops.msm import pack_limb_rows
    g2 = curve != "G1P"
    K = 3
    acc = _pt(g2, 5, 3, 2.0 if not g2 else 1.0)
    cols = [_pt(g2, 20 + 7 * k, 2) for k in range(K)]
    rs = np.random.RandomState(9)
    signs = rs.randint(0, 2, size=(K, N)).astype(np.uint32)
    for c in cols:                       # (0,0) infinity on lane 4
        for leaf in _leaves(c):
            leaf[:, 4] = 0
    jcols = tuple(
        _map(c, lambda a: jnp.asarray(pack_limb_rows(a)))
        + (jnp.asarray(signs[k:k + 1]),) for k, c in enumerate(cols))
    want = JFU.scan_cols_packed(getattr(JC, curve), _map(acc, jnp.asarray),
                                jcols)
    tcols = torch.stack([_packed(c) for c in cols])
    got = TFU.scan_cols_packed(getattr(TC, curve), _packed(acc), tcols,
                               torch.from_numpy(signs.astype(np.int32)))
    assert got.shape == (K, N, 6 if g2 else 3, 8)
    for k in range(K):
        assert torch.equal(got[k], _packed(_map(want[k], np.asarray)))


def _mixed_case(g2, n=8, seed=21):
    """Projective p = a + b (z != 1) and affine q with a doubling lane
    (q = p), a cancellation lane (q = -p), q = infinity and p = infinity."""
    rng = random.Random(seed)
    group, gen = (refc.G2, refc.G2_GEN) if g2 else (refc.G1, refc.G1_GEN)
    a = [group.mul(gen, rng.randrange(1, R_FR)) for _ in range(n)]
    b = [group.mul(gen, rng.randrange(1, R_FR)) for _ in range(n)]
    a[3] = b[3] = None
    ps = [group.add(x, y) for x, y in zip(a, b)]
    qs = [group.mul(gen, rng.randrange(1, R_FR)) for _ in range(n)]
    qs[0] = ps[0]
    qs[1] = group.neg(ps[1])
    qs[2] = None
    return group, a, b, ps, qs


@pytest.mark.parametrize("form", ["packed", "limbs"])
@pytest.mark.parametrize("curve", ["G1P", "G2P"])
def test_plain_add_mixed_matches_jax_fused(curve, form):
    """add_mixed_packed / add_mixed plain versions vs the JAX package's
    fused.add_mixed_packed / add_mixed (their plain XLA reference on the
    CPU): the strict law is canonical, so the words are exact; and the
    sums are group-equal to the oracle after affine normalization."""
    from rapidsnark_tpu.ops.msm import pack_limb_rows
    from rapidsnark_tpu_torch import convert
    g2 = curve != "G1P"
    tcurve, jcurve = getattr(TC, curve), getattr(JC, curve)
    group, a, b, ps, qs = _mixed_case(g2)
    pa, pb = _to_affine_port(tcurve, a, g2), _to_affine_port(tcurve, b, g2)
    p = tcurve.add(tcurve.from_affine(*pa), tcurve.from_affine(*pb))
    q = _to_affine_port(tcurve, qs, g2)
    jp = _map(p, lambda t: jnp.asarray(t.numpy().astype(np.uint32)))
    jq = _map(q, lambda t: jnp.asarray(t.numpy().astype(np.uint32)))
    if form == "packed":
        want = JFU.add_mixed_packed(jcurve, jp, _map(jq, pack_limb_rows))
        got = TFU.add_mixed_packed(tcurve, TC.pack_point(p), TC.pack_point(q))
    else:
        want = JFU.add_mixed(jcurve, jp, jq)
        tq = convert.limb_affine_from_jax([np.asarray(e) for e in _leaves(jq)])
        assert tq.shape == (len(ps), 4 if g2 else 2, 16)
        got = TFU.add_mixed(tcurve, TC.pack_point(p), tq)
    assert torch.equal(got, _packed(_map(want, np.asarray)))
    for g, x, y in zip(_host(TC.unpack_point(tcurve, got), g2), ps, qs):
        e = group.add(x, y)
        assert (g is None and e is None) or group.eq(g, e)


def test_mixed_adders_refuse_other_curves():
    with pytest.raises(ValueError, match="strict mixed adders"):
        TFU._mixed_curve_id(TC.G2P_ISO)
    assert TFU._mixed_curve_id(TC.G1P) == 0 and TFU._mixed_curve_id(TC.G2P) == 1
