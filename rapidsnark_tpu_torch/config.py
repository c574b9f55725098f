"""Runtime knobs of the port (environment variables, as in the JAX
package):

    RSTPU_WINDOW_BITS    Pippenger window size c (default: auto by n)
    RSTPU_WINDOW_GROUP   windows batched per MSM group (default 5)
    RSTPU_MSM_SEGMENT    points per MSM bucket slice (default: 0 up to
                         2^21 points, 2^20 above, 2^19 from 2^24)
    RSTPU_NTT_FUSE       0: per-stage NTT layers (ntt_tail from 2^12
                         points + one ntt_butterfly per other layer);
                         anything else: fused passes (default: fused at
                         every size, one pass a direction up to 2^10)
    RSTPU_NTT_SEQ        1/0: transform a, b, c one at a time / as one
                         stack (default: one at a time from 2^23)
    RSTPU_GLV            0: MSMs without the GLV split (ops/glv.enabled;
                         default on)
    RSTPU_NATIVE         0: the Python file reader; 1: require the native
                         reader (io/native.py; default: native when it
                         can be built)
    RSTPU_COORD          host:port of rank 0's rendezvous, and
    RSTPU_NPROCS         the ranks of a multi-process job, and
    RSTPU_PROC_ID        this process's rank (parallel/multihost.py;
                         every rank runs the same CLI)
    RSTPU_SHARD          1: the CLI spawns one rank per visible card
                         (default 0: one process, one card)
    RSTPU_PROFILE        a directory: Prover.prove writes a torch.profiler
                         trace of each prove there
"""

from __future__ import annotations

import os
from typing import Optional


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def window_bits() -> Optional[int]:
    return _int_env("RSTPU_WINDOW_BITS")


def window_group() -> int:
    v = _int_env("RSTPU_WINDOW_GROUP")
    return 5 if v is None else v


def msm_segment(n: int) -> int:
    """The JAX package's slice rule: whole-axis scans up to 2^21 points."""
    v = _int_env("RSTPU_MSM_SEGMENT")
    if v is not None:
        return v
    if n >= (1 << 24):
        return 1 << 19
    return (1 << 20) if n > (1 << 21) else 0


def ntt_fuse(n: int) -> bool:
    """Whether an n-point transform runs as fused passes; the variable,
    when set, decides at every size. The default differs from the JAX
    package's (per stage below 2^12 points): the port runs a transform of
    up to 2^10 points as one pass a direction, where the per-stage path
    makes a launch a layer. A 1-point transform has no layer to run."""
    v = os.environ.get("RSTPU_NTT_FUSE")
    if v is not None:
        return v != "0"
    return n > 1


def ntt_sequential(power: int) -> bool:
    """Whether the front transforms a, b, c one at a time (a third of the
    NTT's temporaries) instead of as one stack; RSTPU_NTT_SEQ=1/0
    decides when set, else domains of 2^23 and more."""
    v = os.environ.get("RSTPU_NTT_SEQ")
    if v is not None:
        return v != "0"
    return power >= 23


def coordinator() -> Optional[str]:
    return os.environ.get("RSTPU_COORD") or None


def nprocs() -> Optional[int]:
    return _int_env("RSTPU_NPROCS") or None


def proc_id() -> Optional[int]:
    return _int_env("RSTPU_PROC_ID")


def shard() -> bool:
    return os.environ.get("RSTPU_SHARD", "0") != "0"


def profile_dir() -> Optional[str]:
    return os.environ.get("RSTPU_PROFILE") or None
