"""The port's sharded MSM and four-step distributed NTT
(rapidsnark_tpu_torch/parallel) on gloo ranks spawned on the CPU
(parallel/launch.run_ranks, one intra-op thread each) vs the JAX
package's parallel/ over its 8 virtual CPU devices (conftest), the
port's single-rank functions and the oracle.

Tolerances: NTT outputs are canonical field elements, word-identical;
window totals are group-equal (affine-normalized, G1's relaxed
coordinates reduced mod p): projective words depend on the order of the
adds, which differs with the number of ranks."""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh

from rapidsnark_tpu.ops import msm as JM
from rapidsnark_tpu.ops.curve import G1P as JG1P, G2P as JG2P
from rapidsnark_tpu.parallel import pmsm as JPM, pntt as JPN
from rapidsnark_tpu.ref import curve as refc
from rapidsnark_tpu.ref.field import R_FR
from rapidsnark_tpu_torch.ops import msm as TM
from rapidsnark_tpu_torch.ops import ntt as TN
from rapidsnark_tpu_torch.ops.curve import G1P, G2P
from rapidsnark_tpu_torch.parallel import launch, pmsm, pntt
from rapidsnark_tpu_torch.prover import host_g1, host_g2
from rapidsnark_tpu_torch.utils.hostcurve import G1H, G2H

from test_torch_msm import (_affine_window, _affine_window_jax, _points,
                            _scalar_words)
from test_torch_ntt import _packed, _poly
from test_torch_field import port_words, words_of

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)

C, G = 8, 16          # one window group of 16 windows: one scan an MSM
DISTINCT = 64         # distinct points, tiled over the MSM's n
N_MSM = 2048          # the JAX package's 8 devices x 256-column chunks
POWER = 8             # the transform: N1 = N2 = 16, split 2, 4 or 8 ways


def _tables(g2, n, rows, seed):
    """(oracle points of one tile, packed affine table (rows, n, A, 8),
    scalar words (rows, n, 8)); the table tiles DISTINCT points with an
    infinity and a duplicate among them, the scalars hold 0 and 1."""
    pts, words = _points(g2, DISTINCT, seed=seed)
    table = np.broadcast_to(np.tile(words, (n // DISTINCT, 1, 1)),
                            (rows, n) + words.shape[1:]).copy()
    return pts, table, _scalar_words(n, (rows,), seed=seed + 1)


def _oracle(g2, pts, sc_row):
    """sum_i k_i P_(i mod DISTINCT) as the oracle's MSM of the tile with
    the scalars summed mod r per tile position."""
    ks = [int.from_bytes(sc_row[i].astype("<u4").tobytes(), "little")
          for i in range(sc_row.shape[0])]
    agg = [sum(ks[j::DISTINCT]) % R_FR for j in range(DISTINCT)]
    return (refc.G2 if g2 else refc.G1).msm(pts, agg)


def _combined(totals, g2, row):
    """Host Horner combine of one row of window totals (W, rows, L, 8)."""
    H, conv = (G2H, host_g2) if g2 else (G1H, host_g1)
    return H.to_affine(H.combine_windows(
        [conv(totals[w, row]) for w in range(totals.shape[0])], C))


def _msm_rank(mesh, g2, table, sc, segment=0, combine=False):
    """The rank's slice of (table, scalars) through msm_sharded."""
    n = table.shape[1]
    per = n // mesh.size
    lo = mesh.rank * per
    pts = torch.from_numpy(table[:, lo:lo + per].view(np.int32))
    if g2:
        pts = TM.g2_rescale_packed(pts)
    s = torch.from_numpy(sc[:, lo:lo + per].copy().view(np.int32))
    out = pmsm.msm_sharded(G2P if g2 else G1P, pts, s, C, mesh, G,
                           combine=combine, segment=segment)
    return out.numpy().view(np.uint32)


def _dntt_rank(mesh, x):
    """The rank's slice of x (*b, N, 8) forward, and that back again."""
    plan = pntt.DNTTPlan(POWER, mesh.size, "cpu")
    per = x.shape[-2] // mesh.size
    xl = x[..., mesh.rank * per:(mesh.rank + 1) * per, :].contiguous()
    fwd = pntt.dntt(xl, plan.tensors(), plan, mesh)
    back = pntt.dntt(fwd, plan.tensors(), plan, mesh, inverse=True)
    return fwd, back


def _rank_job(mesh, msm_cases, x):
    """Every check's rank-side work in one job (a spawn costs seconds):
    the window totals of each case, the transforms, and the G2 case
    combined on the device."""
    return ([_msm_rank(mesh, *case) for case in msm_cases],
            _dntt_rank(mesh, x),
            _msm_rank(mesh, *msm_cases[1], combine=True))


@pytest.fixture(scope="module")
def inputs():
    g1 = _tables(False, N_MSM, 2, seed=11)
    g2 = _tables(True, N_MSM, 1, seed=13)
    x = _poly(POWER, (2,), seed=17)
    return {False: g1, True: g2, "x": x}


@pytest.fixture(scope="module")
def ranks(inputs):
    """{D: per-rank results of _rank_job} for D = 2 and 4."""
    cases = [(g2, inputs[g2][1], inputs[g2][2]) for g2 in (False, True)]
    x = _packed(inputs["x"])
    return {d: launch.run_ranks(_rank_job, d, cases, x, device="cpu",
                                timeout=900) for d in (2, 4)}


@pytest.fixture(scope="module")
def jax_msm(inputs):
    """The JAX package's msm_sharded window totals over its 8 devices."""
    mesh = JMesh(np.array(jax.devices()), ("shard",))
    out = {}
    for g2 in (False, True):
        _, table, sc = inputs[g2]
        if g2:
            cs = [jnp.asarray(np.moveaxis(table[:, :, k], -1, 0))
                  for k in range(4)]
            jpts = JM.g2_rescale_packed(((cs[0], cs[1]), (cs[2], cs[3])))
        else:
            jpts = tuple(jnp.asarray(np.moveaxis(table[:, :, k], -1, 0))
                         for k in range(2))
        curve = JG2P if g2 else JG1P
        out[g2] = jax.jit(lambda p, s: JPM.msm_sharded(
            curve, p, s, C, mesh, G, combine=False))(jpts, jnp.asarray(sc))
    return out


@pytest.mark.parametrize("nd", [2, 4])
@pytest.mark.parametrize("g2", [False, True])
def test_msm_sharded_group_equal(ranks, jax_msm, inputs, nd, g2):
    """Every rank holds the same totals; each window is group-equal to
    the JAX package's msm_sharded, and each row's combine to the oracle
    MSM (points with an infinity and a duplicate, a zero scalar)."""
    per_rank = [r[0][int(g2)] for r in ranks[nd]]
    for other in per_rank[1:]:
        assert np.array_equal(other, per_rank[0])
    got = per_rank[0]
    pts, _, sc = inputs[g2]
    nwin, rows = got.shape[0], got.shape[1]
    assert nwin == -(-128 // C)
    for b in range(rows):
        for w in range(nwin):
            assert _affine_window(got, g2, w, b) == \
                _affine_window_jax(jax_msm[g2], g2, w, b), (w, b)
        assert _combined(got, g2, b) == _oracle(g2, pts, sc[b])


@pytest.mark.parametrize("nd", [2, 4])
def test_msm_sharded_combined_on_the_device(ranks, inputs, nd):
    """combine=True: the G2 totals summed over the ranks on the iso-twist,
    the Horner ladder there, and the map back give the oracle's MSM on
    every rank."""
    pts, _, sc = inputs[True]
    per_rank = [r[2] for r in ranks[nd]]
    for other in per_rank[1:]:
        assert np.array_equal(other, per_rank[0])
    got = G2H.to_affine(host_g2(per_rank[0][0]))
    assert got == _oracle(True, pts, sc[0])


@pytest.mark.parametrize("nd", [2, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_dntt_word_identical(ranks, inputs, nd, inverse):
    """The ranks' slices joined equal the JAX package's dntt over 8
    devices and the port's single-rank ntt word for word; the inverse
    gives the input back."""
    x = inputs["x"]
    fwd = torch.cat([r[1][0] for r in ranks[nd]], dim=-2)
    back = torch.cat([r[1][1] for r in ranks[nd]], dim=-2)
    tp = TN.NTTPlan(POWER, "cpu").tensors()
    if inverse:
        assert torch.equal(back, _packed(x))
        got, src = back, fwd
    else:
        got, src = fwd, _packed(x)
    single = TN.ntt(src, tp, inverse=inverse)
    assert torch.equal(got, single)
    jplan = JPN.DNTTPlan(POWER, 8)
    arrays = jplan.arrays()
    mesh = JMesh(np.array(jax.devices()), ("shard",))
    jx = jnp.asarray(_unpacked(fwd) if inverse else x)
    want = jax.jit(lambda v: JPN.dntt(v, arrays, jplan, mesh,
                                      inverse=inverse))(jx)
    assert np.array_equal(port_words(got), words_of(want))


def _unpacked(t: torch.Tensor) -> np.ndarray:
    """Packed port words (*b, N, 8) -> the JAX layout (16, *b, N)."""
    w = t.numpy().view(np.uint32)
    limbs = np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(
        w.shape[:-1] + (16,))
    return np.ascontiguousarray(np.moveaxis(limbs, -1, 0))


@pytest.mark.parametrize("power,nd", [(8, 3), (3, 4), (8, 32)])
def test_dntt_plan_rejects_a_split(power, nd):
    """D must divide both N1 and N2, as in the JAX package."""
    with pytest.raises(ValueError):
        JPN.DNTTPlan(power, nd)
    with pytest.raises(ValueError):
        pntt.DNTTPlan(power, nd, "cpu")


def _segment_rank(mesh, table, sc, segment):
    return _msm_rank(mesh, False, table, sc, segment)


def test_segment_padding_three_ranks():
    """D = 3 with a forced segment of 1024 entries and 768 points a rank:
    the segment does not divide a rank's GLV axis (1536 entries), so the
    unpadded local MSM refuses it; pad_len_sharded pads every rank to
    1024 points (two whole slices of its 2048-entry axis), and the
    totals equal the single-rank MSM's and the oracle's."""
    n, seg = 2304, 1024
    assert n // 3 % seg and 2 * (n // 3) > seg
    npad = pmsm.pad_len_sharded(n, 3, seg)
    assert npad == 3 * seg
    assert pmsm.pad_len_sharded(n, 3) == n
    pts, table, sc = _tables(False, n, 1, seed=23)
    with pytest.raises(ValueError):
        TM.msm(G1P, torch.from_numpy(table[:, :n // 3].view(np.int32)),
               torch.from_numpy(sc[:, :n // 3].copy().view(np.int32)), C,
               G, segment=seg)
    table = np.concatenate(
        [table, np.zeros((1, npad - n) + table.shape[2:], np.uint32)], 1)
    sc = np.concatenate([sc, np.zeros((1, npad - n, 8), np.uint32)], 1)
    per_rank = launch.run_ranks(_segment_rank, 3, table, sc, seg,
                                device="cpu", timeout=900)
    for other in per_rank[1:]:
        assert np.array_equal(other, per_rank[0])
    got = per_rank[0]
    single = TM.msm(G1P, torch.from_numpy(table.view(np.int32)),
                    torch.from_numpy(sc.view(np.int32)), C, G)
    single = single.numpy().view(np.uint32)
    for w in range(got.shape[0]):
        assert _affine_window(got, False, w, 0) == \
            _affine_window(single, False, w, 0), w
    assert _combined(got, False, 0) == _oracle(False, pts, sc[0, :n])


def test_mesh_of_one_without_a_job():
    """Without a job global_mesh is a world of one whose collectives are
    copies; msm_sharded then equals msm."""
    from rapidsnark_tpu_torch.parallel import multihost as MH
    mesh = MH.global_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, None)
    rng = random.Random(5)
    t = torch.tensor([rng.randrange(1 << 31) for _ in range(24)],
                     dtype=torch.int32).reshape(3, 8)
    assert torch.equal(mesh.all_gather(t)[0], t)
    assert torch.equal(mesh.all_to_all(t, 0, 1), t)
    assert torch.equal(mesh.broadcast(t), t)
    assert not mesh.stats
    host = np.arange(5 * 2 * 8, dtype=np.uint32).reshape(5, 2, 8)
    assert torch.equal(MH.replicate(host, mesh),
                       torch.from_numpy(host.view(np.int32)))
    # shard_rows cuts the padded length: rank 1 of 2 over 8 rows of 5
    two = MH.Mesh("cpu", rank=1, size=2)
    got = MH.shard_rows(host, two, 0, 8)
    assert got.shape == (4, 2, 8)
    assert torch.equal(got[0], torch.from_numpy(host[4].view(np.int32)))
    assert not got[1:].any()
    with pytest.raises(ValueError):
        MH.shard_rows(host, two, 0, 7)
