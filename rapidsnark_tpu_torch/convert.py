"""Carry device state between the JAX package and the port (tests).

The JAX Prover's `tables()` hold limb-major uint32 arrays: packed point
tables with leaves (8, rows, n), NTT tables (16, n) or packed (8, n),
coefficient slots row-major (rows * K,) / (rows * K, 8), spilled records
in record order. The port holds element-major int32 words, its slots
slot-major (K, rows) and its spilled records sorted by row. Both
directions go through numpy; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops.front import SPILL_TABLES, make_spill


def _w(a) -> np.ndarray:
    return np.array(a, dtype=np.uint32, order="C", copy=True)


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(_w(a).view(np.int32)).to(device)


def _words_rows(a: np.ndarray) -> np.ndarray:
    """(16, ...) limbs or (8, ...) packed words -> (..., 8) words."""
    a = _w(a)
    if a.shape[0] == 16:
        a = a[0::2] | (a[1::2] << 16)
    return np.moveaxis(a, 0, -1)


def tables_from_jax(tables: dict, device="cpu") -> Dict:
    """JAX `Prover.tables()` (as numpy or arrays) -> the port's tables.

    pts_g1 (x, y) leaves (8, 4, n) -> (4, n, 2, 8); pts_g2 ((x0, x1),
    (y0, y1)) leaves (8, 1, n) -> (1, n, 4, 8); NTT rows -> (n, 8);
    coefficient slots -> (K, 2N) / (K, 2N, 8). With spilled coefficient
    records, their target rows (left_seg, through acc2_seg when
    two-level) give the port's row-sorted records and work list
    (ops/front.make_spill) and left_order."""
    x, y = tables["pts_g1"]
    g1 = np.stack([_words_rows(x), _words_rows(y)], axis=-2)
    (x0, x1), (y0, y1) = tables["pts_g2"]
    g2 = np.stack([_words_rows(a) for a in (x0, x1, y0, y1)], axis=-2)
    rows = 2 * np.asarray(tables["ntt"]["coset_ninv_br"]).shape[-1]
    cs = np.asarray(tables["coef_s"]).astype(np.int32).reshape(rows, -1)
    cv = _w(tables["coef_val"]).reshape(rows, cs.shape[1], 8)
    out = {
        "pts_g1": _t(g1, device),
        "pts_g2": _t(g2, device),
        "coef_s": torch.from_numpy(np.ascontiguousarray(cs.T)).to(device),
        "coef_val": _t(cv.transpose(1, 0, 2), device),
        "ntt": {k: _t(_words_rows(v), device)
                for k, v in tables["ntt"].items()
                if k in ("fwd_tw", "inv_tw", "coset_ninv_br")},
    }
    for k in ("left_seg", "acc2_seg"):
        if k in tables:
            out[k] = torch.from_numpy(np.asarray(tables[k])
                                      .astype(np.int64)).to(device)
    if "left_val" in tables:
        seg = out["left_seg"]
        if "acc2_seg" in out:
            seg = out["acc2_seg"][seg]
        spill, out["left_order"] = make_spill(
            torch.from_numpy(np.asarray(tables["left_s"]).astype(np.int64))
            .to(device), _t(tables["left_val"], device), seg, rows)
        out.update(zip(SPILL_TABLES, spill))
    return out


def tables_to_numpy(tables: dict) -> Dict:
    """The port's tables -> numpy uint32 words in the JAX layout (the
    inverse of tables_from_jax, for comparisons)."""
    def rows(t):
        return np.moveaxis(t.cpu().numpy().view(np.uint32), -1, 0)

    def unsorted(t):
        """A row-sorted spill table back in record order."""
        out = torch.empty_like(t)
        out[tables["left_order"].long()] = t
        return out.cpu().numpy()

    g1 = tables["pts_g1"]
    g2 = tables["pts_g2"]
    out = {
        "pts_g1": (rows(g1[..., 0, :]), rows(g1[..., 1, :])),
        "pts_g2": ((rows(g2[..., 0, :]), rows(g2[..., 1, :])),
                   (rows(g2[..., 2, :]), rows(g2[..., 3, :]))),
        "coef_s": tables["coef_s"].T.reshape(-1).cpu().numpy()
        .astype(np.int32),
        "coef_val": tables["coef_val"].transpose(0, 1).reshape(-1, 8)
        .cpu().numpy().view(np.uint32),
        "ntt": {k: rows(v) for k, v in tables["ntt"].items()},
    }
    for k in ("left_seg", "acc2_seg"):
        if k in tables:
            out[k] = tables[k].cpu().numpy().astype(np.int32)
    if "left_val" in tables:
        out["left_s"] = unsorted(tables["left_s"]).astype(np.int32)
        out["left_val"] = unsorted(tables["left_val"]).view(np.uint32)
    return out


def tail_twiddles_from_jax(tws_by_half: dict, n: int, device="cpu"):
    """The JAX package's per-half twiddle rows of `ntt_tail` ({half:
    (16, half)} limbs, half = 1..64) -> the port's twiddle argument: the
    (n/2, 8) table of the direction with the rows those layers read
    filled in (row j * n / (2 * half) for j < half) and zeros elsewhere."""
    out = np.zeros((n // 2, 8), np.uint32)
    for half, rows in tws_by_half.items():
        out[::n // (2 * half)][:half] = _words_rows(rows)
    return _t(out, device)


def limb_affine_from_jax(leaves, device="cpu"):
    """Unpacked affine leaves of the JAX package, each (16, *b) limbs in
    the order x, y (Fq2: c0 before c1) -> the port's limb-form operand
    (*b, A, 16), one 16-bit limb per word."""
    return _t(np.stack([np.moveaxis(_w(a), 0, -1) for a in leaves], axis=-2),
              device)
