"""Training-state checkpoints: save, prune and auto-resume.

Counterpart of ``visionselector_tpu.core.checkpoint`` (orbax there): the
scorer's parameters, the optimizer's state and the step go to
``<dir>/checkpoint-<step>/train_state.pt`` (``torch.save``), with the
reference's directory naming, resume discovery (the highest
``checkpoint-<n>``) and keep-limit pruning. A checkpoint is written under
a temporary name and renamed when complete, so discovery never sees a
partial one. The trained scorer is exported for HF stacks by
``models.qwen25vl.weights.export_scorer_to_safetensors``.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

STATE_FILE = "train_state.pt"
_NAME = re.compile(r"checkpoint-(\d+)")


def _ckpt_dir(output_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")


def _steps(output_dir: str):
    return sorted(int(m.group(1)) for m in map(_NAME.fullmatch,
                                               os.listdir(output_dir)) if m)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """Highest-step ``checkpoint-*`` subdirectory, or None."""
    if not os.path.isdir(output_dir):
        return None
    steps = _steps(output_dir)
    return _ckpt_dir(output_dir, steps[-1]) if steps else None


def save_train_state(state, output_dir: str, step: Optional[int] = None,
                     keep: int = 1) -> str:
    """Save (scorer, optimizer state, step) and keep the newest ``keep``
    checkpoints (at least one). Returns the checkpoint's directory."""
    step = state.step if step is None else step
    path = _ckpt_dir(output_dir, step)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"scorer": state.scorer.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": step}, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    steps = _steps(output_dir)
    for s in steps[:len(steps) - max(1, keep)]:
        if s != step:
            shutil.rmtree(_ckpt_dir(output_dir, s), ignore_errors=True)
    return path


def restore_train_state(path: str, state):
    """Load a checkpoint into ``state`` (its scorer and optimizer, on the
    scorer's device) and return it."""
    device = next(state.scorer.parameters()).device
    blob = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                      weights_only=True)
    with torch.no_grad():
        state.scorer.load_state_dict(blob["scorer"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return state


def maybe_resume(output_dir: str, state):
    """Auto-resume: returns (state, resumed: bool)."""
    path = latest_checkpoint(output_dir)
    if path is None:
        return state, False
    return restore_train_state(path, state), True
