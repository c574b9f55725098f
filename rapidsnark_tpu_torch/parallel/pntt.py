"""The distributed NTT: the four-step algorithm with all-to-all exchanges.

Counterpart of `rapidsnark_tpu/parallel/pntt.py`. With N = N1 * N2,
input n = n1 * N2 + n2 and output k = k2 * N1 + k1:

    X[k2 N1 + k1] = sum_n2 w_N2^(n2 k2) w_N^(n2 k1)
                    sum_n1 w_N1^(n1 k1) a[n1 N2 + n2]

column transforms (size N1), a diagonal twiddle w_N^(k1 n2), row
transforms (size N2). Each rank holds a contiguous 1/D slice of the
natural-order vector; three tiled all-to-alls (Mesh.all_to_all) make the
transposes (n1 | n2) -> (n2 | k1) -> (k1 | k2), so every sub-transform
is a batch of whole transforms on the rank's card (ops/ntt.ntt, fused
passes). Input and output are natural order, sharded contiguously.

Layout: the port's vectors are (*b, N, 8) with the element axis at -2
(the JAX package's is leading limbs, element axis last), so the splits
and joins below run on axes -2 / -3.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import device as D
from ..ops import front
from ..ops.ntt import NTTPlan, ntt, powers_mont
from ..ref.field import R_FR, fr_w
from .multihost import Mesh

SUB_TABLES = ("fwd_tw", "inv_tw", "ninv", "bitrev")


class DNTTPlan:
    """Tables of a size-2^power transform over n_devices ranks, built on
    `device`: the column (N1 = 2^ceil(power/2)) and row (N2 = N / N1)
    sub-plans and the w_N / w_N^-1 power tables (N entries each) for the
    diagonal twiddle. Raises ValueError unless n_devices divides N1 and
    N2, as in the JAX package."""

    def __init__(self, power: int, n_devices: int, device=None):
        self.power = power
        self.n = 1 << power
        p1 = (power + 1) // 2
        self.n1 = 1 << p1
        self.n2 = self.n // self.n1
        if self.n1 % n_devices or self.n2 % n_devices:
            raise ValueError(
                f"n_devices={n_devices} must divide both N1={self.n1} "
                f"and N2={self.n2}")
        self.n_devices = n_devices
        self.device = D.resolve(device)
        w = fr_w(power)
        self._tables = {
            "col": NTTPlan(p1, self.device, keep=SUB_TABLES).tensors(),
            "row": NTTPlan(power - p1, self.device,
                           keep=SUB_TABLES).tensors(),
            "tw_fwd": powers_mont(w, self.n, device=self.device),
            "tw_inv": powers_mont(pow(w, -1, R_FR), self.n,
                                  device=self.device)}

    def tensors(self) -> Dict:
        """{"col": {...}, "row": {...}, "tw_fwd", "tw_inv"} on the plan's
        device."""
        return dict(self._tables)


def dntt(x: torch.Tensor, tables: Dict, plan: DNTTPlan, mesh: Mesh,
         inverse: bool = False) -> torch.Tensor:
    """DFT / inverse DFT of a vector sharded over the ranks: x is this
    rank's contiguous slice (*b, N/D, 8) of natural-order packed values;
    returns its slice of the transform. The inverse's 1/N comes from the
    two sub-inverses (1/N1 and 1/N2)."""
    n1, n2, nd = plan.n1, plan.n2, mesh.size
    if nd != plan.n_devices or x.shape[-2] * nd != plan.n:
        raise ValueError(f"dntt: a slice {tuple(x.shape)} of a 2^"
                         f"{plan.power}-point transform over {nd} ranks "
                         f"(plan for {plan.n_devices})")
    lead = tuple(x.shape[:-2])
    r1, c2 = n1 // nd, n2 // nd
    # (n1 slice | all n2) -> (all n1 | n2 slice), then columns over n1
    x = mesh.all_to_all(x.reshape(lead + (r1, n2, 8)), -2, -3)
    x = ntt(x.transpose(-3, -2).contiguous(), tables["col"], inverse)
    # diagonal twiddle w_N^(k1 * n2g), n2g the global column
    k1 = torch.arange(n1, device=x.device)
    n2g = torch.arange(c2, device=x.device) + mesh.rank * c2
    tw = tables["tw_inv" if inverse else "tw_fwd"][
        (n2g[:, None] * k1[None, :]) % plan.n]                 # (c2, n1, 8)
    x = front.fr_pointwise("mul", x, tw)
    # (n2 slice | all k1) -> (all n2 | k1 slice), then rows over n2
    x = mesh.all_to_all(x, -2, -3)
    x = ntt(x.transpose(-3, -2).contiguous(), tables["row"], inverse)
    # (k1 slice | all k2) -> (all k1 | k2 slice), k2-major natural order
    x = mesh.all_to_all(x, -2, -3)
    return x.transpose(-3, -2).reshape(lead + (c2 * n1, 8)).contiguous()
