"""The port's row gather (rapidsnark_tpu_torch/ops/fused.dma_gather) and
the two gather tools on the CPU.

The JAX tool's Pallas kernel (tools/bench_dma_gather.py) has no
interpret switch and the JAX package's tests never run it; the tool's
own reference, `np.asarray(table)[np.asarray(idx)]`, is what the port is
held against. Tolerance: exact words."""

import numpy as np
import pytest
import torch

from rapidsnark_tpu_torch.ops import fused as TFU
from rapidsnark_tpu_torch.ops import msm as TM
from rapidsnark_tpu_torch.tools import bench_dma_gather, bench_gather

# one intra-op thread per test process (see test_torch_field.py)
torch.set_num_threads(1)


def _case(n, R, repeats, seed):
    rng = np.random.RandomState(seed)
    table = rng.randint(0, 2**31, size=(n, R), dtype=np.int64).astype(
        np.uint32)
    idx = (rng.randint(0, n // 8, size=n) if repeats
           else rng.permutation(n)).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("R", [4, 16, 32])
@pytest.mark.parametrize("repeats", [False, True])
def test_dma_gather_matches_numpy_take(R, repeats):
    table, idx = _case(1024, R, repeats, seed=R)
    got = TFU.dma_gather(torch.from_numpy(table.view(np.int32)),
                         torch.from_numpy(idx), blk=256, nsem=8)
    assert got.dtype == torch.int32 and got.shape == (1024, R)
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(table)[np.asarray(idx)])


@pytest.mark.parametrize("case", ["ragged_m", "blk_not_nsem", "row_words",
                                  "table_dtype", "idx_dtype", "rank",
                                  "nsem_too_large"])
def test_dma_gather_refuses(case):
    table = torch.zeros((512, 16), dtype=torch.int32)
    idx = torch.zeros((512,), dtype=torch.int32)
    kw = {}
    if case == "ragged_m":
        idx = idx[:500]
    elif case == "blk_not_nsem":
        kw = {"blk": 256, "nsem": 24}
    elif case == "row_words":
        table = table[:, :6].contiguous()
    elif case == "table_dtype":
        table = table.long()
    elif case == "idx_dtype":
        idx = idx.long()
    elif case == "rank":
        table = table.reshape(512, 2, 8)
    elif case == "nsem_too_large":
        kw = {"blk": 512, "nsem": 128}
    with pytest.raises(ValueError, match="dma_gather"):
        TFU.dma_gather(table, idx, **kw)


def test_plain_raises_out_of_range():
    table = torch.zeros((8, 4), dtype=torch.int32)
    idx = torch.full((4,), 8, dtype=torch.int32)
    with pytest.raises((IndexError, RuntimeError)):
        TFU.dma_gather(table, idx, blk=4, nsem=4)


def test_gather_cols_is_the_column_layout():
    """ops/msm.gather_cols: column c of chunk k of window g and row b
    holds pts[b, perm[g, b, k*256 + c]]."""
    rng = np.random.RandomState(5)
    n, rows, G = 512, 2, 3
    pts = rng.randint(0, 2**31, size=(rows, n, 2, 8)).astype(np.int32)
    perm = np.stack([[rng.permutation(n) for _ in range(rows)]
                     for _ in range(G)])
    got = TM.gather_cols(torch.from_numpy(pts), torch.from_numpy(perm))
    assert got.shape == (256, G, rows, n // 256, 2, 8)
    want = np.stack([np.stack([pts[b][perm[g, b]] for b in range(rows)])
                     for g in range(G)])            # (G, rows, n, 2, 8)
    want = np.moveaxis(want.reshape(G, rows, n // 256, 256, 2, 8), 3, 0)
    assert np.array_equal(got.numpy(), want)


def test_bench_dma_gather_tool_on_cpu(capsys):
    out = bench_dma_gather.main(["10", "16", "256", "8"], device="cpu")
    text = capsys.readouterr().out
    assert out["correct"] is True and "correct: True" in text
    assert out["device"] == "cpu" and out["launches"] == 0
    assert (out["logn"], out["rowwords"], out["blk"], out["nsem"]) == \
        (10, 16, 256, 8)
    for key in ("dma", "index_select"):
        assert out[key]["ms"] > 0 and out[key]["gb_per_s"] > 0
    assert "Mrows/s" in text and "index_select" in text


def test_bench_gather_tool_on_cpu(capsys):
    out = bench_gather.main(["10", "1", "1"], device="cpu")
    text = capsys.readouterr().out
    assert out["correct"] is True and "correct: True" in text
    assert set(out["cases"]) == {"production gather_cols", "row take + move",
                                 "row take only", "move only", "dma_gather"}
    assert all(v["ms"] > 0 for v in out["cases"].values())


def test_tools_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for tool in (bench_dma_gather, bench_gather):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["10"])
