"""config.msm_plan, the MSM geometry (slice, window bits c, window group
G) the port takes from the H100's memory and measured times, on the CPU:
its table at 2^20-2^24 points on one H100 80GB HBM3, on a 40 GB card and
with 2 and 4 ranks sharing one card, the padding it weighs, the
overrides that win over it in the Prover, and a proof under a geometry
it picks (scaled down) byte-equal to the JAX package's. Tolerance: exact
bytes."""

import os

import numpy as np
import pytest
import torch

from rapidsnark_tpu.io.zkey import read_zkey as j_read_zkey
from rapidsnark_tpu.prover import Prover as JProver
from rapidsnark_tpu_torch import config as C
from rapidsnark_tpu_torch import device as D
from rapidsnark_tpu_torch import fixtures as F
from rapidsnark_tpu_torch.io.wtns import read_wtns
from rapidsnark_tpu_torch.io.zkey import read_zkey, zkey_to_ref
from rapidsnark_tpu_torch.parallel import pmsm as PM
from rapidsnark_tpu_torch.prover import Prover
from rapidsnark_tpu_torch.ref.groth16 import verify

from conftest import FIXTURES

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)

R, S = 1234567890123456789012345678901234567890, 987654321098765432109876543210
GB = 10 ** 9
WIDE = (1 << 22) + 983_040          # the wide 2^22 circuit's points
KNOBS = ("RSTPU_MSM_SEGMENT", "RSTPU_WINDOW_BITS", "RSTPU_WINDOW_GROUP")


def _shape(npts, plan, rows=4):
    """(padded points, entries a slice, working-set bytes, padded cost)
    of a plan, as msm_plan reckons them."""
    seg, c, g = plan
    nmax = PM.pad_len_sharded(npts, 1, seg)
    width = seg or 2 * nmax
    k = max(w for w in C.MSM_COST if 1 << w <= width) \
        if width >= 1 << min(C.MSM_COST) else min(C.MSM_COST)
    ns = dict(((cc, gg), t) for cc, gg, t in C.MSM_COST[k])[(c, g)]
    return nmax, width, width * C.slice_bytes(c, g, rows), 2 * nmax * ns


def _fits(npts, plan, memory, ranks=1, rows=4):
    nmax, _, work, _ = _shape(npts, plan, rows)
    tables = nmax * (rows * C.TABLE_BYTES_G1_ROW + C.TABLE_BYTES_G2)
    return tables + work <= C.MSM_SHARE * memory / ranks


# (log2 points) -> the plan on one H100 80GB HBM3 (85.0 GB), on a 40 GB
# card, and for each rank of 2 and of 4 ranks sharing the 85.0 GB card
TABLE = {
    20: {"85": (0, 16, 8), "40": (0, 16, 8), "D=2": (0, 16, 8),
         "D=4": (0, 16, 8)},
    21: {"85": (0, 16, 8), "40": (0, 16, 4), "D=2": (0, 16, 8),
         "D=4": (0, 16, 8)},
    22: {"85": (1 << 22, 16, 8), "40": (1 << 21, 16, 8), "D=2": (0, 16, 4),
         "D=4": (0, 16, 4)},
    23: {"85": (1 << 22, 16, 8), "40": (1 << 22, 16, 2),
         "D=2": (1 << 22, 16, 4), "D=4": (1 << 21, 16, 4)},
    24: {"85": (1 << 22, 16, 4), "40": (1 << 21, 16, 4),
         "D=2": (1 << 22, 16, 2), "D=4": (1 << 21, 16, 2)},
}


@pytest.mark.parametrize("logn", sorted(TABLE))
def test_plan_table(logn):
    """The plan at 2^20-2^24 points: pinned on each card and share; it
    fits its share of the card; a smaller card or more ranks on the card
    never get a wider slice; on a card that holds its whole axis the
    cheapest candidate is no cheaper than the plan."""
    n = 1 << logn
    got = {"85": C.msm_plan(n, 4, 1, C.CARD_MEMORY),
           "40": C.msm_plan(n, 4, 1, 40 * GB),
           "D=2": C.msm_plan(n // 2, 4, 2, C.CARD_MEMORY),
           "D=4": C.msm_plan(n // 4, 4, 4, C.CARD_MEMORY)}
    assert {k: tuple(v) for k, v in got.items()} == TABLE[logn]
    assert _fits(n, got["85"], C.CARD_MEMORY)
    assert _fits(n, got["40"], 40 * GB)
    assert _shape(n, got["40"])[1] <= _shape(n, got["85"])[1]
    for d in (2, 4):
        p = got[f"D={d}"]
        assert _fits(n // d, p, C.CARD_MEMORY, d)
        assert _shape(n // d, p)[1] <= \
            _shape(n // d, C.msm_plan(n // d, 4, 1, C.CARD_MEMORY))[1]


def test_plan_weighs_padding():
    """The wide 2^22 circuit (5,177,344 points): each slice pads the axis
    to a whole number of slices; the plan's padded cost is the least of
    every candidate that fits, and its padding is what it pays."""
    plan = C.msm_plan(WIDE)
    assert tuple(plan) == (0, 16, 2)
    nmax, _, _, cost = _shape(WIDE, plan)
    assert nmax == WIDE
    for k, opts in C.MSM_COST.items():
        seg = 1 << k
        if seg >= 2 * WIDE:
            continue
        for c, g, _ in opts:
            if _fits(WIDE, (seg, c, g), C.CARD_MEMORY):
                assert _shape(WIDE, (seg, c, g))[3] >= cost


def test_plan_shrinks_and_raises():
    """Less memory never widens the slice; a card too small for the
    tables and the narrowest slice raises (no fallback)."""
    n = 1 << 24
    widths = [_shape(n, C.msm_plan(n, 4, 1, m * GB))[1]
              for m in (85, 60, 40, 30, 22)]
    assert widths == sorted(widths, reverse=True)
    assert widths[-1] < widths[0]
    for m in (8, 20):
        with pytest.raises(ValueError, match="msm_plan"):
            C.msm_plan(n, 4, 1, m * GB)


def _load(name):
    return (read_zkey(os.path.join(FIXTURES, f"{name}.zkey")),
            read_wtns(os.path.join(FIXTURES, f"{name}.wtns")))


def test_prover_takes_the_plan(monkeypatch):
    """With no argument and no variable set, the Prover's (segment, c,
    G) are msm_plan's for its padded axis and the card's memory."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    zk, _ = _load("sqchain64")
    seen = []
    real = C.msm_plan

    def plan(*a):
        seen.append(a)
        return C.MSMPlan(256, 6, 4)

    monkeypatch.setattr(C, "msm_plan", plan)
    p = Prover(zk, device="cpu")
    assert (p.segment, p.c_bits, p.window_group) == (256, 6, 4)
    assert seen == [(256, 4, 1, C.CARD_MEMORY)]
    monkeypatch.setattr(C, "msm_plan", real)
    p = Prover(zk, device="cpu")
    assert p.plan == C.msm_plan(256)
    assert (p.segment, p.c_bits, p.window_group) == tuple(p.plan)


def test_overrides_win_over_the_plan(monkeypatch):
    """The variables win over the plan, the Prover's arguments over
    both, each choice on its own."""
    zk, _ = _load("sqchain64")
    plan = C.msm_plan(256)
    monkeypatch.setenv("RSTPU_MSM_SEGMENT", "256")
    p = Prover(zk, device="cpu")
    assert (p.segment, p.c_bits, p.window_group) == (256, plan.c, plan.G)
    monkeypatch.setenv("RSTPU_WINDOW_BITS", "5")
    monkeypatch.setenv("RSTPU_WINDOW_GROUP", "3")
    p = Prover(zk, device="cpu")
    assert (p.segment, p.c_bits, p.window_group, p.plan) == \
        (256, 5, 3, plan)
    p = Prover(zk, window_bits=6, window_group=2, segment=0, device="cpu")
    assert (p.segment, p.c_bits, p.window_group) == (0, 6, 2)
    p = Prover(zk, window_bits=7, device="cpu")
    assert (p.segment, p.c_bits, p.window_group) == (256, 7, 3)


def test_geometry_sweep_needs_a_card(tmp_path):
    """The measurements behind MSM_COST come from the card only: without
    one the tool exits before it writes a line."""
    from rapidsnark_tpu_torch.tools import geometry_sweep
    out = tmp_path / "sweep.jsonl"
    with pytest.raises(SystemExit, match="no card"):
        geometry_sweep.main([str(out), "sweep"])
    assert not out.exists()


def test_ranks_sharing_a_card_plan_a_share(monkeypatch):
    """A mesh's Prover plans from its rank's axis and the ranks on its
    device (multihost.ranks_on_device): every rank on the CPU, rank %
    cards on a card."""
    from rapidsnark_tpu_torch.parallel import multihost as MH
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert MH.ranks_on_device(MH.Mesh("cpu", 1, 4)) == 4
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    assert MH.ranks_on_device(MH.Mesh("cpu", 1, 6)) == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for idx, want in ((0, 2), (1, 1)):
        mesh = MH.Mesh(torch.device("cuda", idx), idx, 3)
        assert MH.ranks_on_device(mesh) == want


def test_plan_geometry_proof_matches_jax(tmp_path, monkeypatch):
    """The 2^24 plan's geometry scaled down by 2^14: slices of 2^22 /
    2^14 = 256 entries, eight of them as at 2^24, and its window group G,
    at c = 8 (the plain scans' buckets at c = 16 take minutes a window
    group on the CPU; tests/test_torch_msm_plan_c16.py holds c = 16), on
    the wide circuit of domain 64 and 864 wires (1024 padded points). The
    Prover takes that geometry from msm_plan, given 2^-14 of the H100's
    memory; its proof for a fixed (r, s) equals the JAX package's
    Prover's (window_bits=4, as tests/test_prover_device.py runs it) and
    pairing-verifies."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    big = C.msm_plan(1 << 24)
    assert 2 * (1 << 24) // big.segment == 8
    scaled = C.MSMPlan(big.segment >> 14, 8, big.G)
    seen = []

    def plan(*a):
        seen.append(a)
        return scaled

    zpath, wpath = F.generate(6, str(tmp_path), device="cpu", extra=800)
    zk, wt = read_zkey(zpath), read_wtns(wpath)
    monkeypatch.setattr(D, "total_memory", lambda dev: C.CARD_MEMORY >> 14)
    monkeypatch.setattr(C, "msm_plan", plan)
    prover = Prover(zk, device="cpu")
    assert seen == [(1024, 4, 1, C.CARD_MEMORY >> 14)]
    assert (prover.segment, prover.c_bits, prover.window_group,
            prover.nmax) == (256, 8, big.G, 1024)
    proof, publics = prover.prove(wt.values, r=R, s=S)
    assert verify(zkey_to_ref(zk, tables=False), proof, publics)
    jp = JProver(j_read_zkey(zpath), window_bits=4)
    jproof, jpub = jp.prove(np.asarray(wt.values), r=R, s=S)
    assert (proof.a, proof.b, proof.c) == (jproof.a, jproof.b, jproof.c)
    assert publics == jpub
