"""Timing-log scraper (parity with ``qwen-evaluation/extract_time.py``).

Parses the EVAL_TIME lines printed by the engine/adapter::

    Input visual token number is: <int>
    Generation prefill time is: <float ms>
    Generation total time is: <float ms>

into averages. The printed-metric contract is kept identical to the reference
so existing scrape tooling keeps working (SURVEY.md §5.1).
"""

from __future__ import annotations

import re
import sys
from typing import Dict

PATTERNS = {
    "avg_visual_tokens": re.compile(r"Input visual token number is:\s*([\d.]+)"),
    "avg_prefill_ms": re.compile(r"Generation prefill time is:\s*([\d.eE+-]+)"),
    "avg_latency_ms": re.compile(r"Generation total time is:\s*([\d.eE+-]+)"),
}


def extract(text: str) -> Dict[str, float]:
    out = {}
    for key, pat in PATTERNS.items():
        vals = [float(m) for m in pat.findall(text)]
        if vals:
            out[key] = sum(vals) / len(vals)
            out[key.replace("avg_", "n_")] = float(len(vals))
    return out


def main(argv=None) -> int:
    paths = (argv or sys.argv[1:]) or ["-"]
    for path in paths:
        text = sys.stdin.read() if path == "-" else open(path).read()
        stats = extract(text)
        print(path)
        for k, v in sorted(stats.items()):
            print(f"  {k}: {v:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
