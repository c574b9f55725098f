"""Device resolution, kernel build/load, and per-kernel launch counters.

Every entry point of the package takes `device=` and defaults to
"cuda"; with no card present that raises unless the caller asks for
"cpu" (as the CPU tests do). There is no silent CPU path.

The CUDA kernels (csrc/*.cu, plain C interfaces) are compiled at first
use with nvcc for sm_90a into build/rapidsnark_tpu_torch/ at the root of
the checkout, one shared library per source, all sources compiled in
parallel, and loaded with ctypes. A missing nvcc or a failed build
raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
from typing import Dict, Optional

import torch

from .utils.logger import SPAN_PREFIX

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build", "rapidsnark_tpu_torch")
SOURCES = ("curve", "ntt", "gather", "front", "msm", "sort")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("add", "scan_cols_packed", "ntt_fused_pass", "ntt_butterfly",
           "ntt_tail", "add_mixed_packed", "add_mixed", "dma_gather",
           "fr_slot_acc", "fr_pointwise", "glv_digits", "fq_scale",
           "digit_sort", "gather_cols", "prefix_totals")
# launches of each kernel since the last reset_counts(); a wrapper adds
# one for each launch it makes and nowhere else
counts: Dict[str, int] = {k: 0 for k in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = {
    "rs_add": [_I, _VP, _VP, _VP, _LL, _VP],
    "rs_scan_cols": [_I, _VP, _VP, _VP, _VP, _LL, _I, _VP],
    "rs_prefix_totals": [_I, _VP, _VP, _VP, _LL, _LL, _LL, _VP],
    "rs_ntt_butterfly": [_VP, _VP, _VP, _VP, _VP, _LL, _I, _VP],
    "rs_ntt_fused_pass": [_VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _VP],
    "rs_ntt_tail": [_VP, _VP, _VP, _LL, _I, _I, _VP],
    "rs_add_mixed_packed": [_I, _VP, _VP, _VP, _LL, _VP],
    "rs_add_mixed": [_I, _VP, _VP, _VP, _LL, _VP],
    "rs_dma_gather": [_VP, _VP, _VP, _LL, _LL, _I, _I, _I, _VP],
    "rs_fr_slot_acc": [_VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _LL, _VP, _LL,
                       _VP, _VP, _LL, _VP],
    "rs_front_occupancy": [_I, _I, _VP],
    "rs_fr_pointwise": [_I, _VP, _VP, _VP, _VP, _LL, _LL, _VP],
    "rs_glv_digits": [_VP, _LL, _LL, _LL, _VP, _I, _I, _I, _I, _I, _VP, _VP],
    "rs_fq_scale": [_VP, _LL, _LL, _LL, _I, ctypes.c_ulonglong, _I, _VP, _VP,
                    _VP],
    "rs_digit_sort": [_VP, _LL, _LL, _I, _VP, _VP, _VP, _VP, _VP, _VP, _LL,
                      _VP],
    "rs_gather_cols": [_VP, _LL, _LL, _LL, _I, _VP, _LL, _VP, _VP],
}


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller asks
    otherwise; a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path")
    return dev


def total_memory(dev: torch.device) -> int:
    """The card's memory in bytes; on the CPU one H100's
    (config.CARD_MEMORY), so the CPU path plans the card's MSM geometry."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    from .config import CARD_MEMORY
    return CARD_MEMORY


# the lead of a traced block on a card: a spin of about 0.27 s at the
# H100's 1.98 GHz, a host-to-card copy and LEAD_KERNELS small kernels,
# then one short spin as the block's marker
TRACE_LEAD = "spin_kernel"
TRACE_LEAD_CYCLES = 1 << 29
LEAD_KERNELS = 64


def _lead(dev: torch.device) -> None:
    with torch.cuda.device(dev):
        torch.cuda._sleep(TRACE_LEAD_CYCLES)
        x = torch.zeros(1 << 16, dtype=torch.int32).to(dev)
        for _ in range(LEAD_KERNELS):
            x.add_(1)
        torch.cuda._sleep(1)
    torch.cuda.synchronize(dev)


@contextlib.contextmanager
def traced(dev: torch.device, on_ready):
    """torch.profiler over the block (CPU activity, and the card's on a
    card) as the profiler's one active step; on_ready(prof) gets the
    profile when the block ends. A session can lose, in some process
    states, its first card records (on an H100 with torch 2.11 and CUDA
    12.8: a prove's witness copy and first kernels). On a card a lead
    (_lead: a long spin kernel, named TRACE_LEAD, a copy, small kernels,
    a short marker spin) runs in a warm-up step and again at the start
    of the active step, before the block: a warm-up step alone or a
    lead alone each lost records in some smoke runs, both together
    none. block_events(prof.events()) gives the card's events of the
    block, split from the lead on the card's own timeline."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=on_ready,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        if dev.type == "cuda":
            _lead(dev)
        prof.step()
        if dev.type == "cuda":
            _lead(dev)
        yield prof
        prof.step()


def block_events(events) -> list:
    """The card's events of a `traced` block: those that start after the
    end of the last lead spin in the trace, on the card's timeline, less
    the port's span ranges mirrored there (utils/logger.phase), which
    are no card work. Raises when the trace holds no lead spin: it lost
    more than the lead, so the block's first records may be gone too."""
    cuda_t = torch.autograd.DeviceType.CUDA
    card = [e for e in events if e.device_type == cuda_t]
    ends = [e.time_range.end for e in card if TRACE_LEAD in e.name]
    if not ends:
        host = [e.time_range.start for e in events if e.device_type != cuda_t]
        raise RuntimeError(
            "the trace lost its lead kernels, so the block's first card "
            f"records may be lost too: {len(card)} card events, the first "
            f"at {min((e.time_range.start for e in card), default=None)} "
            f"us, the first host event at {min(host, default=None)} us")
    start = max(ends)
    return [e for e in card if e.time_range.start >= start
            and TRACE_LEAD not in e.name
            and not e.name.startswith(SPAN_PREFIX)]


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def count(name: str, launches: int = 1) -> None:
    counts[name] += launches


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(src: str) -> str:
    return os.path.join(BUILD, f"lib{src}.so")


def _stale(src: str) -> bool:
    out = _lib_path(src)
    if not os.path.exists(out):
        return True
    deps = [os.path.join(CSRC, f"{src}.cu"), os.path.join(CSRC, "field.cuh")]
    return any(os.path.getmtime(d) > os.path.getmtime(out) for d in deps)


def build(force: bool = False) -> Dict[str, str]:
    """Compile every stale source (all nvcc processes started together)
    and return {source: compiler output}; raises if any build fails. The
    compiler output (ptxas register/spill report) is also kept beside
    each library as lib<source>.log."""
    todo = [s for s in SOURCES if force or _stale(s)]
    if not todo:
        return {}
    exe = nvcc()
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for src in todo:
        tmp = _lib_path(src) + f".{os.getpid()}.tmp"
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{src}.cu")]
        procs[src] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[src] = out
        with open(os.path.join(BUILD, f"lib{src}.log"), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(src)
        else:
            os.replace(tmp, _lib_path(src))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[s] for s in failed))
    return logs


def lib(src: str) -> ctypes.CDLL:
    """The loaded kernel library of csrc/<src>.cu (built on first use)."""
    h = _libs.get(src)
    if h is None:
        build()
        h = ctypes.CDLL(_lib_path(src))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(h, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[src] = h
    return h


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require(t: torch.Tensor, name: str, dtype=torch.int32,
            tail: Optional[tuple] = None) -> None:
    """Wrapper-side argument checks before a launch."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if tail is not None and tuple(t.shape[-len(tail):]) != tuple(tail):
        raise ValueError(f"{name}: trailing shape {tuple(t.shape)} "
                         f"is not (..., {', '.join(map(str, tail))})")
