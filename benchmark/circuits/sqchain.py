"""The sqchain circuit family in lanes: `lanes` independent chains of
`steps` rows each, row k = j * steps + t of lane j reading

    x_{j,t} * x_{j,t} = x_{j,t+1} - k

so A and B hold one record a row (wire x_{j,t}, value 1) and C two (wire
x_{j,t+1} with 1, the constant wire 0 with -k). With one lane this is the
port's own sqchain circuit (rapidsnark_tpu_torch/fixtures.sqchain_coo at
commit 6caa3f5: the same rows, wires and values); with many, each lane
starts from a free private input, so the witness is computed lane-parallel
on the device in `steps` sequential steps instead of one step a row.

Wires: 0 is the constant one, 1 the one public signal (the last lane's
final value), then lane j's values x_{j,0..steps} at 2 + j (steps + 1) + t,
the last lane's final value excepted (it is wire 1). So n_vars =
lanes (steps + 1) + 1 and n_constraints = lanes * steps."""

from __future__ import annotations

import numpy as np
import torch

from ..frozen import field as FF
from ..frozen.field import FR
from ..frozen.ref_field import R_FR
from ..keygen import Coo


def sizes(lanes: int, steps: int):
    """(n_vars, n_public, n_constraints)."""
    return lanes * (steps + 1) + 1, 1, lanes * steps


def _wire(lanes: int, steps: int, j: np.ndarray, t: np.ndarray):
    w = 2 + j * (steps + 1) + t
    return np.where((j == lanes - 1) & (t == steps), 1, w)


def coo(lanes: int, steps: int) -> Coo:
    """The constraint system as COO arrays sorted by (m, k, s)."""
    n_vars, n_public, nc = sizes(lanes, steps)
    if nc >= int(R_FR & 0xFFFFFFFF):
        raise ValueError("sqchain: too many rows for a one-word -k")
    k = np.arange(nc, dtype=np.int64)
    j, t = k // steps, k % steps
    cur, nxt = _wire(lanes, steps, j, t), _wire(lanes, steps, j, t + 1)
    ones = np.zeros((nc, 8), np.uint32)
    ones[:, 0] = 1
    neg_k = np.zeros((nc, 8), np.uint32)
    neg_k[:] = np.frombuffer(R_FR.to_bytes(32, "little"), "<u4")
    neg_k[:, 0] -= k.astype(np.uint32)
    neg_k[k == 0] = 0                                    # -0 = 0
    # within a C row wire 0 sorts first
    c_s = np.stack([np.zeros(nc, np.int64), nxt], axis=1).reshape(-1)
    c_v = np.stack([neg_k, ones], axis=1).reshape(-1, 8)
    return Coo(
        n_vars, n_public, nc,
        m=np.concatenate([np.zeros(nc, np.int64), np.ones(nc, np.int64),
                          np.full(2 * nc, 2, np.int64)]),
        k=np.concatenate([k, k, np.repeat(k, 2)]),
        s=np.concatenate([cur, cur, c_s]),
        value=np.concatenate([ones, ones, c_v]))


def starts(lanes: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Each lane's start, a uniform residue below r drawn from gen on dev:
    (lanes, 8) int32 plain words."""
    w = torch.randint(0, 1 << 32, (lanes, 8), generator=gen,
                      dtype=torch.int64, device=dev)
    w[:, 7] %= R_FR >> 224                               # below r
    return FF.to_i32(w)


def chain(lanes: int, steps: int, start, dev="cpu") -> np.ndarray:
    """The witness from the lanes' starts ((lanes, 8) plain words): every
    lane's chain, in `steps` lane-parallel steps on dev; (n_vars, 8)
    uint32 standard-form words, the wtns layout."""
    n_vars, _, _ = sizes(lanes, steps)
    if isinstance(start, np.ndarray):
        start = torch.from_numpy(np.ascontiguousarray(start, np.uint32)
                                 .view(np.int32))
    x = FR.to_mont(FF.unpack(start.to(dev)))              # (16, lanes)
    vals = torch.empty((steps + 1, 16, lanes), dtype=torch.int64,
                       device=dev)
    word = torch.zeros((lanes, 8), dtype=torch.int64, device=dev)
    word[:, 0] = torch.arange(lanes, dtype=torch.int64, device=dev) * steps
    kbase = FR.to_mont(FF.unpack(FF.to_i32(word)))       # j * steps
    for t in range(steps):
        vals[t] = x
        kt = FR.add(kbase, FR.const(t * (1 << 256) % R_FR, (lanes,), dev))
        x = FR.add(FR.mul(x, x), kt)                     # + k, k = j steps + t
    vals[steps] = x
    vals = vals.permute(1, 2, 0).reshape(16, -1)         # lane-major
    plain = torch.empty((vals.shape[1], 8), dtype=torch.int32, device=dev)
    for lo in range(0, vals.shape[1], 1 << 22):
        plain[lo:lo + (1 << 22)] = FF.pack(FR.from_mont(
            vals[:, lo:lo + (1 << 22)]))
    del vals
    out = torch.empty((n_vars, 8), dtype=torch.int32, device=dev)
    out[0] = 0
    out[0, 0] = 1
    # lane j's values x_{j,0..steps} at 2 + j (steps + 1) + t in order;
    # the last lane's final value is wire 1
    out[2:] = plain[:-1]
    out[1] = plain[-1]
    return out.cpu().numpy().view(np.uint32)


def witness(lanes: int, steps: int, gen: torch.Generator, dev) -> np.ndarray:
    """One witness: the lanes' starts drawn from gen on dev, then their
    chains."""
    return chain(lanes, steps, starts(lanes, gen, dev), dev)
