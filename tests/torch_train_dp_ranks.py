"""The processes of tests/test_torch_train_dp.py (``torch_world.World``): a
world of 2 gloo ranks and a world of 1 (no process group) run the same
``api.train`` command lines side by side. This module imports no jax.

``train_rank`` runs each case of ``inputs["cases"]`` that names its world
size through ``api.train.main`` with ``--output-dir`` under
``inputs["tmp"]/w<world>/``, recording the trainables' gradients at the
first update (after the data-parallel average, before the clip) and the
trained tensors after the last, which it writes to an ``.npz`` beside;
the world of 2 also runs one selector step on the JAX tree's weights
(``dp_step``) for the test to hold against the reference's
``train_step`` on a (2, 1) mesh."""

from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _spy(record):
    """A stand-in for ``train_step._update`` that records the first
    update's gradients and every update's trained tensors."""
    from visionselector_tpu_torch.train import train_step

    update = train_step._update

    def spy(state, sched):
        if "grad" not in record:
            record["grad"] = {n: p.grad.detach().clone().numpy()
                              for n, p in state.trainable().items()}
        res = update(state, sched)
        record["trained"] = {n: p.detach().clone().numpy()
                             for n, p in state.trainable().items()}
        return res

    return spy


def _ragged(rollout_group):
    """``rollout_group`` with completion g of the prompt seeded ``seed``
    cut to 1 + (seed + g) % its length tokens: the same cut in every
    world, and token counts that differ between a world's ranks (the
    tiny random model never samples its EOS, so every completion would
    run to the same length)."""
    def rollout(*args, seed=0, **kwargs):
        comps = rollout_group(*args, seed=seed, **kwargs)
        return [c[:1 + (seed + g) % len(c)] for g, c in enumerate(comps)]

    return rollout


def run_cli(argv, out_dir, arrays_path, hooks=()) -> dict:
    """``api.train.main(argv)`` with its stdout / stderr captured: the
    return code, the log (rank 0's file), the printed lines and the path
    of the recorded arrays. ``hooks``: "ragged_rollouts" (``_ragged``),
    "no_grad_sum" (the planted fault: the metrics averaged over the
    ranks, the gradients left each rank's own)."""
    from visionselector_tpu_torch.api import train as tapi
    from visionselector_tpu_torch.train import grpo, train_step

    record = {}
    out, err = io.StringIO(), io.StringIO()
    mean = train_step.data_mean
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(train_step, "_update", _spy(record)))
        if "no_grad_sum" in hooks:
            stack.enter_context(_patched(
                train_step, "data_mean",
                lambda mesh, grads, metrics: mean(mesh, [], metrics)))
        if "ragged_rollouts" in hooks:
            stack.enter_context(_patched(grpo, "rollout_group",
                                         _ragged(grpo.rollout_group)))
        stack.enter_context(contextlib.redirect_stdout(out))
        stack.enter_context(contextlib.redirect_stderr(err))
        rc = tapi.main(argv + ["--output-dir", out_dir])
    log_path = os.path.join(out_dir, "train_log.jsonl")
    log = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = [json.loads(ln) for ln in f]
    np.savez(arrays_path, **{f"{kind}:{n}": a for kind in ("grad", "trained")
                             for n, a in record.get(kind, {}).items()})
    return dict(rc=rc, log=log, stdout=out.getvalue(), stderr=err.getvalue(),
                arrays=arrays_path, steps=len(record))


def dp_step(inputs) -> dict:
    """One selector update of the tiny model with the JAX tree's weights on
    this rank's part of ``inputs["batch"]`` (a stacked host batch), over
    the world's data mesh: its metrics and the averaged gradients."""
    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.core.mesh import batch_sharding, data_mesh
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        from_jax_params,
    )
    from visionselector_tpu_torch.train import train_step
    from visionselector_tpu_torch.train.loss import to_device

    params = from_jax_params(inputs["tree"], qwen25vl_tiny(), "cpu")
    mesh = data_mesh(inputs["batch"].input_ids.shape[0], device="cpu")
    local = batch_sharding(mesh)
    batch = to_device(type(inputs["batch"])(*map(local, inputs["batch"])),
                      "cpu")
    sched = train_step.ScheduleConfig(**inputs["sched"])
    state = train_step.init_train_state(params, sched)
    state.mesh = mesh
    record = {}
    with _patched(train_step, "_update", _spy(record)):
        _, metrics = train_step.train_step(state, params, batch,
                                           qwen25vl_tiny(), inputs["k_max"],
                                           sched)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grad=record["grad"], local_rows=int(batch.input_ids.shape[0]))


def train_rank(rank, world, inputs) -> dict:
    out = {}
    base = os.path.join(inputs["tmp"], f"w{world}")
    for name, argv, worlds, hooks in inputs["cases"]:
        if world not in worlds:
            continue
        out[name] = run_cli(argv, os.path.join(base, name), os.path.join(
            inputs["tmp"], f"w{world}_r{rank}_{name}.npz"), hooks)
    if world == 2:
        out["dp_step"] = dp_step(inputs)
    return out


def arrays(path) -> dict:
    """{"grad": {name: array}, "trained": {...}} from ``run_cli``'s file."""
    got = {"grad": {}, "trained": {}}
    with np.load(path) as z:
        for key in z.files:
            kind, name = key.split(":", 1)
            got[kind][name] = z[key]
    return got
