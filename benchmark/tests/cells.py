"""Helpers of the CPU tests: a copy of the benchmark with a tiny cell
added as new files and new entries, and one run of it in a subprocess."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {"circuit": "sqchain", "log2_domain": 6, "lanes": 3, "steps": 20,
        "n_vars": 64, "n_public": 1, "n_constraints": 60,
        "chips": 1, "reduced": [], "assumed": {}, "deployment": "tests"}


def copy_with_tiny(dst: str, traffic: dict, name: str = "tiny") -> str:
    """dst/ holding BENCHMARK.json and benchmark/ as they are, plus a tiny
    configuration (2^6) and a cell `<name>.<mix>` for each mix in
    `traffic` (name -> traffic file), added as new files and entries;
    every metric that lists cells lists the tiny ones of its entry too.
    Returns dst."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(dst, "benchmark", "configs", name + ".json"),
              "w") as f:
        json.dump(TINY, f)
    spec["configs"].append({"name": name, "source": "tests",
                            "file": f"benchmark/configs/{name}.json",
                            "reduced": [], "why": "tests"})
    for mix, body in traffic.items():
        path = os.path.join(dst, "benchmark", "traffic", mix + ".json")
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump(body, f)
        cell = f"{name}.{mix}"
        spec["workloads"].append({"name": cell, "config": name,
                                  "traffic": mix, "chips": 1,
                                  "why": "tests"})
        like = "d24.warm" if body["entry"] == "prove" else "d20.cli"
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return dst


def run_cell(where: str, cell: str, seed: int = 3000000019,
             seconds: float = 0.5, extra=()) -> tuple:
    """(return code, last stdout line as JSON or None, stderr) of one run
    of `cell` on the CPU from the copy at `where`."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", "0",
         "--device", "cpu", *extra],
        cwd=where, env=env, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, out, proc.stderr


WARM = {"loop": "closed", "clients": 1, "entry": "prove", "witnesses": 2,
        "warmup_ops": 1, "traced_ops": 1}
CLI = {"loop": "closed", "clients": 1, "entry": "cli", "witnesses": 2,
       "warmup_ops": 1, "traced_ops": 1, "check_sample": 2}
