"""Cross-revision score regression runner for the PyTorch port
(counterpart of ``visionselector_tpu.eval.regression``, after
``lmms-eval/tools/regression.py``): run a fixed task list with a small
``--limit`` at several git refs (or the working tree) and print the
scores side by side, flagging drift.

Usage:
    python -m visionselector_tpu_torch.eval.regression \\
        --data-dir eval_data --tasks chartqa --limit 8 \\
        --refs HEAD~1,HEAD [--model-path /ckpt] [--device cuda]

Each ref runs ``python -m visionselector_tpu_torch.api.run_eval`` in a
process of its own: ``WORKTREE`` in the current directory, any other ref
in a ``git worktree`` of it (so it needs a git checkout; a tree without
``.git`` runs ``WORKTREE`` only). ``--device`` is passed to run_eval
(cuda, the default, fails without a GPU).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def run_eval_at_ref(ref: str | None, args) -> dict:
    """run_eval's results at ``ref`` (None: the current tree)."""
    cwd = os.getcwd()
    tmp = None
    try:
        if ref is not None:
            tmp = tempfile.mkdtemp(prefix=f"vst_reg_{ref.replace('/', '_')}_")
            subprocess.run(["git", "worktree", "add", "--detach", tmp, ref],
                           check=True, capture_output=True)
            cwd = tmp
        out_dir = tempfile.mkdtemp(prefix="vst_reg_out_")
        cmd = [
            sys.executable, "-m", "visionselector_tpu_torch.api.run_eval",
            "--data-dir", os.path.abspath(args.data_dir),
            "--tasks", args.tasks,
            "--method", args.method,
            "--budgets", str(args.budget),
            "--limit", str(args.limit),
            "--output-dir", out_dir,
            "--device", args.device,
        ]
        if args.model_path:
            cmd += ["--model-path", os.path.abspath(args.model_path)]
        subprocess.run(cmd, check=True, cwd=cwd)
        with open(os.path.join(
                out_dir, f"{args.method}_{args.budget}_rank0.json")) as f:
            return json.load(f)["results"]
    finally:
        if tmp:
            subprocess.run(["git", "worktree", "remove", "--force", tmp],
                           capture_output=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--tasks", required=True)
    p.add_argument("--refs", default="WORKTREE",
                   help="comma-separated git refs; WORKTREE = current tree")
    p.add_argument("--method", default="selector")
    p.add_argument("--budget", type=float, default=0.2)
    p.add_argument("--limit", type=int, default=8)
    p.add_argument("--model-path", default=None)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="passed to run_eval: cuda (default) or cpu")
    args = p.parse_args(argv)

    rows = {}
    for ref in args.refs.split(","):
        rows[ref] = run_eval_at_ref(ref if ref != "WORKTREE" else None, args)

    keys = sorted({k for r in rows.values() for k in r if "/" in k})
    print(f"{'metric':40s} " + " ".join(f"{r:>12s}" for r in rows))
    for k in keys:
        vals = [rows[r].get(k, float("nan")) for r in rows]
        drift = (max(vals) - min(vals)) if all(
            isinstance(v, (int, float)) for v in vals) else 0
        flag = "  <-- drift" if drift > 1e-9 and k.split("/")[1] not in (
            "wall_s", "stderr") else ""
        print(f"{k:40s} " + " ".join(f"{v:12.4f}" for v in vals) + flag)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
