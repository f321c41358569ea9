"""Run one cell of the benchmark of ``visionselector_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for (``BENCHMARK.json``). Set-up (imports, the kernel library,
weights made on the card from the seed, the traffic, a warm-up of the
cell's shapes), then the measured window of ``--seconds``, then the check
of what was served against the plain reference. The last line of
standard output is the result as one JSON object; the numbers compared
for ``correct`` are also the last lines of standard error. With
``--trace 1`` the metrics are the cell's per-layer ones, read from a
profiler window at the end of the measured one.

A run that finds JAX or the JAX package loaded (compared by whole
top-level module names) after set-up, at the window's close or just
before it prints the result exits with code 4 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    age = harness.process_age_s()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    setup = harness.Setup(age)
    harness.set_caches()
    bench = harness.manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        out = harness.serve_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), setup)
        # after the window (in ``serve_cell``), and again once the check
        # against the reference has run, just before the result
        if out["notes"]["forbidden"]:
            raise harness.ForbiddenImport(
                f"forbidden modules loaded by the window's close: "
                f"{out['notes']['forbidden']}")
        harness.check_imports("at exit")
    except harness.ForbiddenImport as e:
        print(e, file=sys.stderr)
        return 4
    print(json.dumps(out["notes"]), file=sys.stderr)
    for name, v in out["result"]["compared"].items():
        print(f"compared {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
