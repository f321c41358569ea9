"""Selector evaluation entry point of the PyTorch port
(``qwen-evaluation/run_selector.sh``: the paper's image suite at retention
budgets 0.1 / 0.2 / 0.3, EVAL_TIME probes), a thin wrapper over
``api.run_eval``.

Usage:
    python -m visionselector_tpu_torch.api.run_selector \\
        --model-path /ckpt --data-dir eval_data [--tasks ...] [--budgets ...]
"""

from __future__ import annotations

import sys

PAPER_TASKS = ("docvqa_val,chartqa,textvqa_val,ocrbench,scienceqa_img,"
               "ai2d_no_mask,mmmu_val,mme,pope")


def selector_argv(argv) -> list:
    """``run_eval`` arguments: the paper's tasks and budgets unless given,
    ``--method selector``."""
    argv = list(argv)
    if not any(a.startswith("--tasks") for a in argv):
        argv += ["--tasks", PAPER_TASKS]
    if not any(a.startswith("--budgets") for a in argv):
        argv += ["--budgets", "0.1,0.2,0.3"]
    return argv + ["--method", "selector"]


def main(argv=None) -> int:
    from visionselector_tpu_torch.api.run_eval import main as run_eval_main

    return run_eval_main(selector_argv(sys.argv[1:] if argv is None
                                       else argv))


if __name__ == "__main__":
    raise SystemExit(main())
