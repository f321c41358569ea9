"""Training-state checkpoints: save (in the foreground or on a background
writer), prune and auto-resume.

Counterpart of ``visionselector_tpu.core.checkpoint`` (orbax there): a
state's trained tensors (``state.trainable()``: the scorer, the dynamic
predictor, the SFT trainables or the LoRA adapters), its optimizer's
state, its step and, where it has one, its generator's state go to
``<dir>/checkpoint-<step>/train_state.pt`` (``torch.save``), with the
reference's directory naming, resume discovery (the highest
``checkpoint-<n>``) and keep-limit pruning. A checkpoint is written under
a temporary name and renamed when complete, so discovery never sees a
partial one.

``AsyncSaver`` is ``--async-save``: the reference's orbax
``AsyncCheckpointer``, one background writer with at most one save in
flight. The optimizer updates the parameters in place, so a save first
copies everything it writes to the host, in the foreground, before the
writer starts: the next step cannot change what is being written.

``save_params`` writes a whole model's parameters (the LoRA-merged model
at the end of ``api.train``; the reference's orbax save of the merged
tree).
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Callable, Optional

import torch

STATE_FILE = "train_state.pt"
PARAMS_FILE = "params.pt"
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


def _host(obj):
    """``obj`` with every tensor in it copied to the host (dicts, lists and
    tuples walked; other values kept)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _snapshot(state, step: int) -> dict:
    """What a checkpoint of ``state`` holds, copied to the host now."""
    blob = {"params": _host(state.trainable()),
            "optimizer": _host(state.optimizer.state_dict()),
            "step": step}
    generator = getattr(state, "generator", None)
    if generator is not None:
        blob["generator"] = generator.get_state()
    return blob


def _write(blob: dict, output_dir: str, step: int, keep: int) -> None:
    path = _ckpt_dir(output_dir, step)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(blob, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    steps = _steps(output_dir)
    for s in steps[:len(steps) - max(1, keep)]:
        if s != step:
            shutil.rmtree(_ckpt_dir(output_dir, s), ignore_errors=True)


class AsyncSaver:
    """One background checkpoint writer. ``submit(write)`` first waits for
    the write in flight, then runs ``write`` on a new thread; an exception
    raised by a write is raised again by the next ``submit`` or by
    ``finalize_saves``. Call ``finalize_saves`` before reading a checkpoint
    back, before an export and before exiting (``api.train`` calls it in
    its ``finally``)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def submit(self, write: Callable[[], None]) -> None:
        self.finalize_saves()

        def run():
            try:
                write()
            except Exception as e:  # noqa: BLE001 - raised by finalize_saves
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint-save")
        self._thread.start()

    def finalize_saves(self) -> None:
        """Block until the write in flight (if any) is on disk."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def save_train_state(state, output_dir: str, step: Optional[int] = None,
                     keep: int = 1, saver: Optional[AsyncSaver] = None
                     ) -> str:
    """Save ``state`` (its trained tensors, optimizer state, step and
    generator state) and keep the newest ``keep`` checkpoints (at least
    one). With ``saver`` the host copy is taken here and the write runs on
    the saver's thread. Returns the checkpoint's directory."""
    step = state.step if step is None else step
    blob = _snapshot(state, step)
    if saver is None:
        _write(blob, output_dir, step, keep)
    else:
        saver.submit(lambda: _write(blob, output_dir, step, keep))
    return _ckpt_dir(output_dir, step)


def restore_train_state(path: str, state):
    """Load a checkpoint into ``state`` (its trained tensors, optimizer,
    step and generator) and return it. Raises ValueError when the
    checkpoint holds other tensors than ``state.trainable()`` (another
    method's run, or another LoRA rank)."""
    blob = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    params = state.trainable()
    if set(blob["params"]) != set(params):
        raise ValueError(f"{path} holds {len(blob['params'])} trained "
                         f"tensors that do not match this run's "
                         f"{len(params)} (another --method or LoRA rank?)")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(blob["params"][name])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    if "generator" in blob:
        state.generator.set_state(blob["generator"])
    return state


def maybe_resume(output_dir: str, state):
    """Auto-resume: returns (state, resumed: bool)."""
    path = latest_checkpoint(output_dir)
    if path is None:
        return state, False
    return restore_train_state(path, state), True


def save_params(module: torch.nn.Module, directory: str) -> str:
    """Write every parameter of ``module`` (its ``state_dict``) to
    ``<directory>/params.pt``, through a temporary name. Returns the
    file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, PARAMS_FILE)
    torch.save(_host(module.state_dict()), path + ".tmp")
    os.replace(path + ".tmp", path)
    return path
