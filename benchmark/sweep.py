"""The knee of an open-loop cell: its traffic at several fixed rates, one
run each in one process, with how far each fell behind.

    python3 benchmark/sweep.py --workload <cell> --rates 2,3,4 \\
        --seconds <s> --seed <n>

Not run by the benchmark's own runs. One JSON line a rate: requests due
in the window and completed, those still waiting at its close, the
median time to first token in each half of the window, and p90.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness, traffic  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    harness.set_caches()
    cell = {w["name"]: w for w in harness.manifest()["workloads"]}[
        args.workload]
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(traffic.load_mix(cell["traffic"]), rate_per_s=rate)
        out = harness.serve_cell(cell, args.seed, args.seconds, False,
                                 harness.Setup(0.0), mix=mix)
        r, n = out["result"], out["notes"]
        print(json.dumps({
            "rate_per_s": rate, "due": r["attempted"],
            "completed": r["attempted"] - r["failed"],
            "waiting_at_close": n["waiting_at_close"],
            "ttft_p50_ms_halves": n["ttft_p50_ms_halves"],
            "ttft_p90_ms": r["metrics"].get("ttft_p90_ms", {}).get("value"),
            "correct": r["correct"], "compared": r["compared"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
