"""Port NTT (rapidsnark_tpu_torch/ops/ntt.py) and its two kernels' plain
versions vs the JAX package (the CUDA kernels are held against these
plain versions in test_torch_kernels.py). Tolerance: exact words
throughout (every output is a canonical field element, or the same op
sequence on the same words)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rapidsnark_tpu.ops import fused as JFU
from rapidsnark_tpu.ops import ntt as JN
from rapidsnark_tpu.ref.field import R_FR
from rapidsnark_tpu_torch.ops import fused as TFU
from rapidsnark_tpu_torch.ops import ntt as TN
from rapidsnark_tpu_torch.ops import field as TF

from test_torch_field import limbs, port_words, rand_vals, to_t, words_of


def _poly(power, batch=(), seed=0):
    n = int(np.prod(batch or (1,))) << power
    return limbs(rand_vals(R_FR, n, seed=seed)).reshape(
        (16,) + batch + (1 << power,))


def _packed(a) -> torch.Tensor:
    return TF.pack(to_t(a))


@pytest.mark.parametrize("power", [6, 12])
def test_plan_tables_match_jax(power):
    jp, tp = JN.NTTPlan(power), TN.NTTPlan(power, "cpu")
    ja, ta = jp.arrays(), tp.arrays()
    for k in ("fwd_tw", "inv_tw", "coset", "coset_ninv_br"):
        assert np.array_equal(words_of(ja[k]), ta[k]), k
    assert np.array_equal(words_of(ja["ninv"]), ta["ninv"])
    assert np.array_equal(ja["bitrev"], ta["bitrev"])
    assert jp.eta == tp.eta


@pytest.mark.parametrize("power,batch", [(6, (3,)), (12, ())])
def test_to_odd_coset_matches_jax(power, batch):
    """2^6 runs one fused pass a direction, 2^12 two (JAX on the CPU runs
    its per-stage path: the transforms must agree)."""
    jp, tp = JN.NTTPlan(power), TN.NTTPlan(power, "cpu")
    ja = {k: jnp.asarray(v) for k, v in jp.arrays().items()}
    x = _poly(power, batch, seed=power)
    want = jax.jit(lambda v: JN.to_odd_coset(v, ja, jp.eta))(jnp.asarray(x))
    got = TN.to_odd_coset(_packed(x), tp.tensors())
    assert np.array_equal(port_words(got), words_of(want))


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_jax(inverse, power=6):
    jp, tp = JN.NTTPlan(power), TN.NTTPlan(power, "cpu")
    ja = {k: jnp.asarray(v) for k, v in jp.arrays().items()}
    x = _poly(power, (2,), seed=3)
    want = jax.jit(lambda v: JN.ntt(v, ja, inverse=inverse))(jnp.asarray(x))
    got = TN.ntt(_packed(x), tp.tensors(), inverse=inverse)
    assert np.array_equal(port_words(got), words_of(want))


@pytest.mark.parametrize("dif", [False, True])
def test_plain_butterfly_matches_jax_fused(dif):
    lo, hi, tw = (_poly(5, (3,), seed=s) for s in (1, 2, 3))
    want = JFU.ntt_butterfly(jnp.asarray(lo), jnp.asarray(hi),
                             jnp.asarray(tw), dif=dif)
    got = TFU.ntt_butterfly(_packed(lo), _packed(hi), _packed(tw), dif)
    for g, w in zip(got, want):
        assert np.array_equal(port_words(g), words_of(w))


@pytest.mark.parametrize("dif", [False, True])
def test_plain_fused_pass_matches_jax_fused(dif, power=12):
    """The port's whole fused-pass transform vs the JAX package's fused
    transform (its ntt_fused_pass in Pallas interpret mode), with the
    coset pre-multiply on the DIT side."""
    tp = TN.NTTPlan(power, "cpu").arrays()
    x = _poly(power, (), seed=5)
    tw = tp["inv_tw"] if dif else tp["fwd_tw"]
    jtw = jnp.asarray(np.moveaxis(
        np.stack([tw & 0xFFFF, tw >> 16], axis=-1).reshape(-1, 16), 0, 1))
    pm = None if dif else tp["coset_ninv_br"]
    jpm = None if pm is None else jnp.asarray(words_of_packed_rows(pm))
    want = JN._fused_transform(jnp.asarray(x), jtw, dif=dif, pre_mul=jpm)
    got = (TN._stages_dif(_packed(x)[None], torch.from_numpy(
               tw.view(np.int32))) if dif
           else TN._stages_dit(_packed(x)[None], torch.from_numpy(
               tw.view(np.int32)), pre_mul=torch.from_numpy(
               pm.view(np.int32))))
    assert np.array_equal(port_words(got[0]), words_of(want))


def _jax_rows(w: np.ndarray):
    """(n, 8) u32 words -> the JAX (16, n) limb-row layout."""
    return jnp.asarray(np.moveaxis(
        np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(-1, 16), 0, 1))


@pytest.mark.parametrize("dif", [False, True])
def test_plain_tail_matches_jax_fused(dif, power=9):
    """ntt_tail plain version vs the JAX package's fused.ntt_tail (its
    plain XLA form on the CPU), vs the seven lowest layers as one fused
    pass, and from the JAX per-half twiddle rows carried by convert."""
    from rapidsnark_tpu_torch import convert
    tp = TN.NTTPlan(power, "cpu").arrays()
    n = 1 << power
    x = _poly(power, (2,), seed=7)
    tw = tp["inv_tw"] if dif else tp["fwd_tw"]
    tws = JN._tail_tws(_jax_rows(tw), n, 7)
    assert sorted(tws) == [1, 2, 4, 8, 16, 32, 64]
    # one polynomial per call: the JAX plain form's field mul does not
    # broadcast its twiddle row over a batch axis
    want = np.stack([words_of(JFU.ntt_tail(jnp.asarray(x[:, b]), tws,
                                           dif=dif)) for b in range(2)])
    ttw = torch.from_numpy(tw.view(np.int32))
    got = TFU.ntt_tail(_packed(x), ttw, dif)
    assert np.array_equal(port_words(got), want)
    assert torch.equal(got, TFU.ntt_fused_pass_plain(_packed(x), ttw, 0, 7,
                                                     dif))
    carried = convert.tail_twiddles_from_jax(
        {h: np.asarray(r) for h, r in tws.items()}, n)
    assert torch.equal(TFU.ntt_tail(_packed(x), carried, dif), got)
    with pytest.raises(ValueError, match="power of two"):
        TFU.ntt_tail(_packed(x)[:, :64], ttw, dif)


@pytest.mark.parametrize("power", [12, 14])
def test_to_odd_coset_per_stage(power, monkeypatch):
    """RSTPU_NTT_FUSE=0 at N >= 2^12: ntt_tail plus one ntt_butterfly
    layer per upper bit gives the fused configuration's words and the JAX
    package's (which runs per stage under the same setting)."""
    from rapidsnark_tpu_torch import config, device as D
    jp, tp = JN.NTTPlan(power), TN.NTTPlan(power, "cpu")
    ja = {k: jnp.asarray(v) for k, v in jp.arrays().items()}
    x = _poly(power, (), seed=power)
    fusedw = TN.to_odd_coset(_packed(x), tp.tensors())
    monkeypatch.setenv("RSTPU_NTT_FUSE", "0")
    assert not config.ntt_fuse(1 << power) and not JN._fuse_enabled(1 << power)
    calls = []
    real = TFU.ntt_tail
    monkeypatch.setattr(TFU, "ntt_tail",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = TN.to_odd_coset(_packed(x), tp.tensors())
    assert len(calls) == 2          # one DIF tail, one DIT tail
    assert torch.equal(got, fusedw)
    want = jax.jit(lambda v: JN.to_odd_coset(v, ja, jp.eta))(jnp.asarray(x))
    assert np.array_equal(port_words(got), words_of(want))
    assert D.counts["ntt_tail"] == 0     # plain versions are not launches


def test_ntt_fuse_knob_matches_jax(monkeypatch):
    """Unset, the port fuses at every size above one point (the JAX
    package from 2^12, on its TPU); set, the two read the variable
    alike."""
    from rapidsnark_tpu_torch import config
    monkeypatch.delenv("RSTPU_NTT_FUSE", raising=False)
    assert [config.ntt_fuse(1 << p) for p in (0, 1, 6, 11, 12, 20)] == \
        [False, True, True, True, True, True]
    for v in ("0", "1", ""):
        monkeypatch.setenv("RSTPU_NTT_FUSE", v)
        for p in (6, 12, 20):
            assert config.ntt_fuse(1 << p) == JN._fuse_enabled(1 << p)


SMALL = [(p, None) for p in range(1, 12)] + [(p, "0") for p in (1, 7, 11)]


@pytest.mark.parametrize("op", ["to_odd_coset", "inverse_ntt"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("power,knob", SMALL)
def test_small_transforms_match_jax(power, knob, batch, op, monkeypatch):
    """Below 2^12 points: by default one fused pass a direction up to
    2^10 (two at 2^11) and no per-layer butterfly; with RSTPU_NTT_FUSE=0
    one butterfly a layer. Either way the JAX package's per-stage path's
    words (JAX on the CPU runs per stage below 2^12 whatever the knob)."""
    if knob is None:
        monkeypatch.delenv("RSTPU_NTT_FUSE", raising=False)
    else:
        monkeypatch.setenv("RSTPU_NTT_FUSE", knob)
    jp, tp = JN.NTTPlan(power), TN.NTTPlan(power, "cpu")
    ja = {k: jnp.asarray(v) for k, v in jp.arrays().items()}
    x = _poly(power, (batch,), seed=power + 20 * batch)
    if op == "to_odd_coset":
        want = jax.jit(lambda v: JN.to_odd_coset(v, ja, jp.eta))(
            jnp.asarray(x))
    else:
        want = jax.jit(lambda v: JN.ntt(v, ja, inverse=True))(jnp.asarray(x))
    calls = {"ntt_fused_pass": 0, "ntt_butterfly": 0}
    for name in calls:
        real = getattr(TFU, name)
        monkeypatch.setattr(TFU, name, lambda *a, _r=real, _n=name, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _r(*a, **k))[1])
    if op == "to_odd_coset":
        got = TN.to_odd_coset(_packed(x), tp.tensors())
    else:
        got = TN.ntt(_packed(x), tp.tensors(), inverse=True)
    assert np.array_equal(port_words(got), words_of(want))
    directions = 2 if op == "to_odd_coset" else 1
    if knob is None:
        assert calls == {"ntt_fused_pass": directions * (1 + (power > 10)),
                         "ntt_butterfly": 0}
    else:
        assert calls == {"ntt_fused_pass": 0,
                         "ntt_butterfly": directions * power}


def words_of_packed_rows(w: np.ndarray) -> np.ndarray:
    """(n, 8) u32 words -> the JAX (8, n) packed-row layout."""
    return np.ascontiguousarray(w.T)
