"""One run of one benchmark cell of the port (rapidsnark_tpu_torch):

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the cell's CUDA cards.
It makes the cell's inputs from the seed, sets up and warms up, measures
for --seconds, checks every answer against the plain reference, and
prints one JSON object as the last line of standard output (the numbers
compared, each beside its limit, also as the last lines of standard
error). Without the cards it asks for, it prints no result and exits 1.
--device cpu (for the CPU tests) runs the port's plain path instead;
--fault plants a fault (faults.py) for the control and the tests."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from . import harness
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), T0, device=args.device,
                          fault=args.fault)
    except harness.Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
