"""Spawned worlds of ranks for the port's parallel CPU tests. This module
imports no jax: each rank is a spawned process that re-imports it and
the module of its target.

``World(worlds, tmp_dir, target, inputs)`` pickles ``inputs`` under
``tmp_dir`` and starts, all at once, one process per rank of each world
size in ``worlds``: the ranks of a world of n > 1 join a gloo process
group over a ``file://`` rendezvous under ``tmp_dir`` (finite timeout);
a world of 1 is one process with no process group. Each process calls
``target(rank, world, inputs)`` (a module-level function of a module
that imports no jax) with one intra-op thread. ``World.results()`` waits
for them and returns ``{world: [each rank's output]}``; a target that
raises reports its traceback as ``{"error": ...}``."""

from __future__ import annotations

import datetime
import os
import pickle
import traceback

import torch

TIMEOUT = 300  # seconds for every process to report
# seconds a rank waits in one collective: a rank that failed leaves the
# others waiting this long before they fail too
GROUP_TIMEOUT = 60


def _rank_main(rank, world, init_method, target, inputs_path, results):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)
        if world > 1:
            from visionselector_tpu_torch.core.mesh import init_world

            init_world(rank, world, init_method, "gloo",
                       timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
        out = target(rank, world, inputs)
    except Exception:  # noqa: BLE001 — the test reports it
        out = {"error": traceback.format_exc()}
    results.put((world, rank, out))
    if dist.is_initialized():
        dist.destroy_process_group()


class World:
    def __init__(self, worlds, tmp_dir: str, target, inputs: dict):
        import torch.multiprocessing as mp

        path = os.path.join(tmp_dir, "inputs.pkl")
        with open(path, "wb") as f:
            pickle.dump(inputs, f, protocol=pickle.HIGHEST_PROTOCOL)
        ctx = mp.get_context("spawn")
        self._queue = ctx.Queue()
        self._procs = []
        for n in worlds:
            init = f"file://{os.path.join(tmp_dir, f'rendezvous{n}')}"
            for r in range(n):
                p = ctx.Process(target=_rank_main, args=(
                    r, n, init, target, path, self._queue))
                p.start()
                self._procs.append(p)
        self._worlds = tuple(worlds)

    def results(self) -> dict:
        try:
            got = [self._queue.get(timeout=TIMEOUT) for _ in self._procs]
        finally:
            for p in self._procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
        out = {n: [None] * n for n in self._worlds}
        for n, r, res in got:
            out[n][r] = res
        return out
