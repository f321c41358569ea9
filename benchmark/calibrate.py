"""Readings the limits of ``correct`` are set from: for each seed, one
short run of a cell (its own load and check) in one process, the numbers
compared for the program and for the fp8 control on the same requests,
and whether each would pass the mix's limits (the control must not).

    python3 benchmark/calibrate.py --workload <cell> --seeds a,b,... \\
        --seconds <s> [--out file.jsonl]

Not run by the benchmark's own runs. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness, judge, traffic  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="judge the fp8 control on the first N seeds")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.set_caches()
    cell = {w["name"]: w for w in harness.manifest()["workloads"]}[
        args.workload]
    limits = traffic.load_mix(cell["traffic"])["check"]["limits"]
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = harness.serve_cell(cell, seed, args.seconds, False,
                                 harness.Setup(0.0),
                                 control=i < args.control_seeds)
        low = out["control"]
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "program": out["numbers"], "control": low,
                           "correct": out["result"]["correct"],
                           "control_correct": None if low is None
                           else judge.verdict(low, limits)[0],
                           "metrics": out["result"]["metrics"]})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
