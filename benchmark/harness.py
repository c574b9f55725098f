"""One run of one cell: inputs from the seed, set-up, the measured
window, the traced window, the reference's check, the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in BENCHMARK.json: configs/<config>.json (and the
circuit family it names, circuits/<family>.py), traffic/<mix>.json, and
metrics/<metric>.py for every metric, end-to-end and per-layer alike.
The mix names its entry, entries/<entry>.py, which the one general
generator (generator.py) drives by the mix's parameters."""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import random
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass

import torch

from . import entries, generator, keygen, trace
from .reference import Reference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rapidsnark_tpu")


class Refused(Exception):
    """The run cannot measure (no card, an unknown cell): no result."""


@dataclass
class Run:
    """What a metric reader reads. ops: the window's op records (entries/,
    with generator.py's arrival and client); window_s: from the window's
    start to its last answer; traced:
    with --trace 1, trace.read's dict plus the traced ops' "records", and
    on a card "window_s", "busy_s" and the "busy" intervals, else None;
    plan: the MSM geometry the port chose; sizes: the circuit's domain,
    n_vars and n_public."""
    workload: str
    entry: str
    setup_s: float
    ops: list
    window_s: float
    peak_bytes: int
    plan: dict
    sizes: dict
    traced: dict = None


def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, name: str):
    """(workload entry, config entry, config file, traffic file)."""
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise Refused(f"no workload named {name!r} in BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == wl["config"])
    with open(os.path.join(ROOT, cfg["file"])) as f:
        cfg_file = json.load(f)
    with open(os.path.join(HERE, "traffic", wl["traffic"] + ".json")) as f:
        mix = json.load(f)
    why = generator.validate(mix)
    if not why and not entries.exists(mix.get("entry", "")):
        why = f"no entry {mix.get('entry')!r} (benchmark/entries/)"
    if why:
        raise Refused(f"traffic {wl['traffic']}: {why}")
    return wl, cfg, cfg_file, mix


def reader(name: str):
    """metrics/<name>.py's read(run) -> a number, or None where it finds
    nothing to read."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(spec: dict, workload: str, kind: str) -> list:
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Inputs:
    """The cell's inputs from the seed: the constraint system, the key
    (made on dev), the witnesses and a stream of blindings (r, s)."""

    def __init__(self, cfg_name: str, cfg: dict, mix: dict, seed: int, dev,
                 parts: dict):
        fam = importlib.import_module(f"benchmark.circuits.{cfg['circuit']}")
        t = time.perf_counter()
        self.coo = fam.coo(cfg["lanes"], cfg["steps"])
        got = (self.coo.n_vars, self.coo.n_public, self.coo.n_constraints,
               keygen.domain_of(self.coo).bit_length() - 1)
        want = (cfg["n_vars"], cfg["n_public"], cfg["n_constraints"],
                cfg["log2_domain"])
        if got != want:
            raise ValueError(f"{cfg_name}: the circuit has (n_vars, "
                             f"n_public, n_constraints, log2_domain) {got}, "
                             f"the file states {want}")
        parts["circuit"] = time.perf_counter() - t
        self.key = keygen.make_key(self.coo, f"{cfg_name}:{seed}", dev,
                                   parts)
        t = time.perf_counter()
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed % (1 << 63))
        self.witnesses = [fam.witness(cfg["lanes"], cfg["steps"], gen, dev)
                          for _ in range(mix["witnesses"])]
        parts["witnesses"] = time.perf_counter() - t
        self._name = f"{cfg_name}:{seed}"
        self._rs = self.rng("rs")
        self._sample = self.rng("sample")

    def rng(self, what: str) -> random.Random:
        """A stream drawn from the seed, one for each use."""
        return random.Random(f"{self._name}:{what}")

    def blinding(self) -> tuple:
        """(r, s): 31 random bytes each, as the port draws its own."""
        return (int.from_bytes(self._rs.randbytes(31), "little"),
                int.from_bytes(self._rs.randbytes(31), "little"))

    def sample(self, n_ops: int, k: int) -> list:
        """k op indices of n_ops drawn from the seed, the last among them."""
        rest = self._sample.sample(range(n_ops - 1), min(k, n_ops) - 1)
        return sorted(rest) + [n_ops - 1]


def _traced(entry, inputs, mix: dict, first: int, dev, workdir) -> dict:
    path = os.path.join(workdir, "trace.json")
    with trace.traced(dev, path):
        recs, _, failed = generator.drive(entry, inputs, mix, first,
                                          count=mix["traced_ops"],
                                          span=trace.op_span)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    got = trace.read(path, card=dev.type == "cuda")
    os.remove(path)
    got["records"], got["failed"] = recs, failed
    if dev.type == "cuda" and got["ops"]:
        lo, hi = got["ops"][0][0], got["ops"][-1][1]
        busy = trace.busy_union(got["card"], lo, hi)
        got["window_s"] = (hi - lo) * 1e-6
        got["busy_s"] = sum(t - s for s, t in busy) * 1e-6
        got["busy"] = busy
    return got


def breakdown(got: dict, recs: list, entry) -> dict:
    """The traced window's ten costliest card operations by name, and its
    ten longest idle gaps, each labelled by what the host was doing."""
    per = {}
    for name, cat, ts, d in got["card"]:
        k = trace.kernel_name(name) if cat == "kernel" else name
        per[k] = per.get(k, 0.0) + d * 1e-6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    lo, hi = got["ops"][0][0], got["ops"][-1][1]
    gaps = trace.idle_gaps(got["busy"], lo, hi)
    labelled = []
    for s, t in gaps:
        mid = 0.5 * (s + t)
        labelled.append([_label(mid, got, recs, entry), (t - s) * 1e-6])
    labelled.sort(key=lambda g: -g[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": labelled[:10]}


def _label(ts: float, got: dict, recs: list, entry) -> str:
    for j, (s, t) in enumerate(got["ops"]):
        if s <= ts <= t:
            return entry.gap_label(ts, s, t, got["card"], recs[j])
    return "between ops"


def run(workload: str, seed: int, seconds: float, traced: bool, t0: float,
        device: str = None, fault: str = None) -> dict:
    """One run; returns the result line's object (checks last)."""
    spec = load_spec()
    wl, cfg_entry, cfg, mix = cell(spec, workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < wl["chips"]:
            raise Refused(f"{workload} needs {wl['chips']} CUDA card(s); "
                          f"{torch.cuda.device_count()} available")
        device = "cuda"
    dev = torch.device(device)
    import rapidsnark_tpu_torch  # noqa: F401  (the system under test)
    parts = {"imports": time.perf_counter() - t0}
    workdir = tempfile.mkdtemp(prefix="benchmark-")
    try:
        return _run(spec, wl, cfg_entry, cfg, mix, seed, seconds, traced,
                    t0, dev, parts, workdir, fault)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(spec, wl, cfg_entry, cfg, mix, seed, seconds, traced, t0, dev,
         parts, workdir, fault):
    from . import faults
    inputs = Inputs(cfg_entry["name"], cfg, mix, seed, dev, parts)
    t = time.perf_counter()
    entry = entries.load(mix["entry"])(inputs.key, inputs.witnesses, dev,
                                       workdir)
    if fault:
        entry = faults.wrap(fault, entry, inputs)
    parts["entry"] = time.perf_counter() - t
    t = time.perf_counter()
    _, _, failed = generator.drive(entry, inputs, mix, -mix["warmup_ops"],
                                   count=mix["warmup_ops"], paced=False)
    parts["warmup"] = time.perf_counter() - t
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    print("setup_parts " + json.dumps(parts), file=sys.stderr)

    recs, window_s, wfailed = generator.drive(entry, inputs, mix, 0,
                                              seconds=seconds)
    failed += wfailed
    print("op_seconds " + json.dumps([round(r["t1"] - r["t0"], 4)
                                      for r in recs]), file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    got = None
    after = {}
    t = time.perf_counter()
    if traced:
        got = _traced(entry, inputs, mix, len(recs), dev, workdir)
        failed += got["failed"]
        after["traced"] = time.perf_counter() - t
        t = time.perf_counter()
    plan = entry.plan
    entry.close()                # the port's state freed before the check
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    bad = forbidden_modules()
    if bad:
        raise Refused("modules that the port must not load: "
                      + ", ".join(bad))

    key = inputs.key
    run_ = Run(wl["name"], mix["entry"], setup_s, recs, window_s, peak,
               plan, {"domain": key.domain, "n_vars": key.n_vars,
                      "n_public": key.n_public},
               traced=got)
    ref = Reference(inputs.coo, key.toxic, dev)
    all_recs = recs + (got["records"] if got else [])
    sample = (inputs.sample(len(recs), mix.get("check_sample", len(recs)))
              + list(range(len(recs), len(all_recs)))) if recs else []
    checks = {"failed_ops": (len(failed), 0)}
    checks.update(entry.check(inputs, ref, all_recs, sample))
    ref.free()
    after["release + check"] = time.perf_counter() - t
    print("after_window_parts " + json.dumps(after), file=sys.stderr)

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in metrics_for(spec, wl["name"], kind):
        v = reader(m["name"])(run_)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": wl["chips"], "memory_peak_bytes": peak}
    out = {"correct": bool(all_recs)
           and all(v <= lim for v, lim in checks.values()),
           "attempted": len(recs) + len(failed) + (
               len(got["records"]) if got else 0),
           "failed": len(failed), "metrics": metrics, "device": device}
    if got is not None and "busy_s" in got:
        device["busy_s"] = got["busy_s"]
        device["window_s"] = got["window_s"]
        out["breakdown"] = breakdown(got, got["records"], entry)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
