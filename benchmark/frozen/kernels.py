# Adapted from rapidsnark_tpu_torch/device.py (build, lib, require) and
# rapidsnark_tpu_torch/ops/fused.py (add_mixed_packed, add_mixed) at commit
# 6caa3f5 for the benchmark's input maker: only the strict mixed adds of
# the frozen csrc/curve.cu, built into build/benchmark/ of the checkout.
"""The input maker's two kernels: the strict mixed adds of the frozen
csrc/curve.cu (G1 with a packed affine operand, G2 on the zkey's twist
with a limb-form one). A CUDA tensor launches the kernel; a CPU tensor
runs the plain version of frozen/curve.py. The library is compiled with
nvcc for sm_90a on first use into <checkout>/build/benchmark/, a fixed
path, so later runs in the same checkout load it as it is."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

from .curve import G1P, G2P, is_g2, pack_point, unpack_point

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                     "benchmark")
LIB = os.path.join(BUILD, "libcurve.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the input maker's kernels "
                           "cannot be built")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB):
        return True
    deps = [os.path.join(CSRC, f) for f in ("curve.cu", "field.cuh")]
    return any(os.path.getmtime(d) > os.path.getmtime(LIB) for d in deps)


def lib() -> ctypes.CDLL:
    """The loaded library, built first when missing or older than its
    sources; a failed build raises."""
    global _lib
    if _lib is None:
        if _stale():
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{LIB}.{os.getpid()}.tmp"
            out = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, "curve.cu")],
                capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError("nvcc failed for the input maker's "
                                   f"kernels:\n{out.stdout}{out.stderr}")
            os.replace(tmp, LIB)
        h = ctypes.CDLL(LIB)
        for name in ("rs_add_mixed_packed", "rs_add_mixed"):
            fn = getattr(h, name)
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = h
    return _lib


def _require(t: torch.Tensor, name: str, tail: tuple) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int32 tensor")
    if tuple(t.shape[-len(tail):]) != tuple(tail):
        raise ValueError(f"{name}: trailing shape {tuple(t.shape)} is not "
                         f"(..., {', '.join(map(str, tail))})")


def _unpack_limb_point(curve, q: torch.Tensor):
    els = [q[..., i, :].movedim(-1, 0).to(torch.int64)
           for i in range(q.shape[-2])]
    if is_g2(curve):
        els = [(els[i], els[i + 1]) for i in range(0, len(els), 2)]
    return tuple(els)


def _launch(name: str, curve, p, q, limbs: int):
    cid = 0 if curve is G1P else 1
    L = 6 if is_g2(curve) else 3
    _require(p, f"{name}.p", (L, 8))
    _require(q, f"{name}.q", (L - L // 3, limbs))
    if p.shape[:-2] != q.shape[:-2]:
        raise ValueError(f"{name}: batch shapes differ")
    out = torch.empty_like(p)
    n = p.numel() // (L * 8)
    rc = getattr(lib(), "rs_" + name)(
        cid, p.data_ptr(), q.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    return out


def add_mixed_packed(curve, p: torch.Tensor, q: torch.Tensor):
    """Strict complete add of projective p (*b, L, 8) and packed affine q
    (*b, A, 8), (0,0) = infinity, on G1 or G2's twist; canonical out."""
    if curve is not G1P and curve is not G2P:
        raise ValueError("the strict mixed adds serve G1 and G2's twist")
    if p.device.type == "cpu":
        return pack_point(curve.add_mixed(unpack_point(curve, p),
                                          unpack_point(curve, q)))
    return _launch("add_mixed_packed", curve, p, q, 8)


def add_mixed(curve, p: torch.Tensor, q: torch.Tensor):
    """add_mixed_packed with q in limb form (*b, A, 16), one 16-bit limb
    a word."""
    if curve is not G1P and curve is not G2P:
        raise ValueError("the strict mixed adds serve G1 and G2's twist")
    if p.device.type == "cpu":
        return pack_point(curve.add_mixed(unpack_point(curve, p),
                                          _unpack_limb_point(curve, q)))
    return _launch("add_mixed", curve, p, q, 16)
