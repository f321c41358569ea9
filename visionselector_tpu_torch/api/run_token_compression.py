"""All-methods comparison driver (the reference's
``qwen-evaluation/run_token_compression.sh``): runs ``api.run_eval`` once
per method, the uncompressed control arm and every training-free baseline
over the same budgets; every other argument goes to ``run_eval`` as it is.

Usage:
    python -m visionselector_tpu_torch.api.run_token_compression \\
        --model-path /ckpt --data-dir eval_data \\
        [--methods orig,selector,fastv,...] [--budgets 0.1,0.2,0.3] ...
"""

from __future__ import annotations

import argparse
import sys

DEFAULT_METHODS = ("orig,selector,fastv,visionzip,prumerge_plus,dart,"
                   "divprune,holov,dynamic")


def main(argv=None) -> int:
    from visionselector_tpu_torch.api.run_eval import main as run_eval_main

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--methods", default=DEFAULT_METHODS)
    known, rest = pre.parse_known_args(
        sys.argv[1:] if argv is None else list(argv))
    rc = 0
    for method in known.methods.split(","):
        method = method.strip()
        if not method:
            continue
        print(f"=== method: {method} ===")
        rc |= run_eval_main(rest + ["--method", method])
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
