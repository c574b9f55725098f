"""The ways a traffic mix drives the port, one file an entry: the mix's
"entry" names entries/<entry>.py, whose class `Entry` is built at set-up
as Entry(key, witnesses, dev, workdir) and offers

  op(i, widx, r, s)  one operation on witness widx with blinding (r, s)
                     (None where the port draws its own); returns a
                     record: its host-clock span (t0, t1), widx, r, s, the
                     answer (or where to read it) and the port's own spans
                     (Prover.last_phases, and for a new Prover
                     Prover.setup_phases)
  check(inputs, ref, recs, sample)
                     the numbers compared, {name: (value, limit)}: the
                     records' answers against the plain reference
  gap_label(ts, start, end, card, rec)
                     what the host was doing at trace time ts inside the
                     op's traced span [start, end] (card: its card events)
  plan, close()      the MSM geometry the port chose; release the port

These files are the only places the benchmark calls the port. A new way
to call it is a new file here and a mix that names it."""

from __future__ import annotations

import importlib
import os

from ..frozen.points import g1_affine_to_mont_limbs, g2_affine_to_mont_limbs
from ..frozen.ref_field import P, R_FR

HERE = os.path.dirname(os.path.abspath(__file__))


def exists(name: str) -> bool:
    return not name.startswith("_") and \
        os.path.isfile(os.path.join(HERE, name + ".py"))


def load(name: str):
    """The Entry class of entries/<name>.py."""
    return importlib.import_module(f"{__name__}.{name}").Entry


def zkey_of(key):
    """The port's in-memory ZKey (rapidsnark_tpu_torch.io.zkey) of a key."""
    from rapidsnark_tpu_torch.io.zkey import ZKey
    vk = key.vk
    return ZKey(
        n8q=32, q=P, n8r=32, r=R_FR, n_vars=key.n_vars,
        n_public=key.n_public, domain_size=key.domain,
        n_coefs=key.coef_m.shape[0],
        vk_alpha1=g1_affine_to_mont_limbs(vk["alpha1"]),
        vk_beta1=g1_affine_to_mont_limbs(vk["beta1"]),
        vk_beta2=g2_affine_to_mont_limbs(vk["beta2"]),
        vk_gamma2=g2_affine_to_mont_limbs(vk["gamma2"]),
        vk_delta1=g1_affine_to_mont_limbs(vk["delta1"]),
        vk_delta2=g2_affine_to_mont_limbs(vk["delta2"]),
        coef_m=key.coef_m, coef_c=key.coef_c, coef_s=key.coef_s,
        coef_val=key.coef_val, points_a=key.points_a,
        points_b1=key.points_b1, points_b2=key.points_b2,
        points_c=key.points_c, points_h=key.points_h, ic=key.ic)


def plan_of(prover) -> dict:
    return {"c": prover.c_bits, "nmax": prover.nmax,
            "segment": prover.segment, "G": prover.window_group}


def phase_label(ts: float, start: float, phases: dict) -> str:
    """The Prover span (front / msms / host) that trace time ts (us) falls
    in, counting from the op's start."""
    cur = start
    for name in ("front", "msms", "host"):
        cur += phases.get(name, 0.0) * 1e6
        if ts <= cur:
            return name
    return "host"
