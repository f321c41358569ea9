"""Evaluation result persistence (lmms-eval parity:
``lmms-eval/lmms_eval/loggers/evaluation_tracker.py`` — aggregated results +
per-sample records with run metadata; ``loggers/wandb_logger.py`` — optional
experiment tracker).

``EvaluationTracker.save_results_aggregated`` writes
``<dir>/results_<timestamp>.json`` carrying the metric dict plus run metadata
(model args, git hash, timings); ``save_results_samples`` writes one
``<task>_<timestamp>.jsonl`` per task. A W&B run is attached when the
``wandb`` package is importable AND ``wandb_args`` are passed (the build
environment has no network; the hook degrades to a no-op).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Dict, List, Optional


def _git_hash() -> Optional[str]:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except Exception:  # noqa: BLE001
        return None


@dataclasses.dataclass
class EvaluationTracker:
    output_dir: str
    model_name: str = ""
    model_args: str = ""
    wandb_args: Optional[dict] = None

    def __post_init__(self):
        import uuid

        os.makedirs(self.output_dir, exist_ok=True)
        self._t0 = time.time()
        # uuid suffix: sweeps create one tracker per (method, budget) cell and
        # cells finishing within the same second must not clobber each other
        self._stamp = (
            time.strftime("%Y%m%dT%H%M%S") + "_" + uuid.uuid4().hex[:8]
        )
        self._wandb = None
        if self.wandb_args:
            try:
                import wandb  # noqa: F401 — optional, absent in this env

                self._wandb = wandb.init(**self.wandb_args)
            except Exception:  # noqa: BLE001
                self._wandb = None

    def save_results_aggregated(self, results: Dict[str, float],
                                config: Optional[dict] = None) -> str:
        payload = {
            "results": results,
            "config": config or {},
            "model_name": self.model_name,
            "model_args": self.model_args,
            "git_hash": _git_hash(),
            "date": self._stamp,
            "total_evaluation_time_seconds": round(time.time() - self._t0, 2),
        }
        path = os.path.join(self.output_dir, f"results_{self._stamp}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        if self._wandb is not None:
            self._wandb.log(results)
        return path

    def save_results_samples(self, task_name: str,
                             samples: List[dict]) -> str:
        path = os.path.join(
            self.output_dir, f"{task_name}_{self._stamp}.jsonl"
        )
        with open(path, "w") as f:
            for s in samples:
                f.write(json.dumps(s) + "\n")
        return path

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
