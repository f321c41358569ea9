"""Tensor-parallel serving: ``api.serve --tp N`` (the reference's
``serve.py:754-782``, where GSPMD shards the weights over a (1, N) mesh).

The process that runs ``build_server`` is rank 0: it holds the HTTP
server, the engine lock, the batcher and every host decision. ``start``
builds the CUDA kernels once, then spawns ranks 1 .. N-1 (``follow``),
which load the same weights, shard the decoder (``mesh.tensor_parallel``:
``lm.shard_lm`` over the mesh's "model" axis; the vision tower and the
scorer stay whole on every rank) and build a Server of their own with no
HTTP and no worker threads. Rank 0 announces each engine operation of
its Server, micro-batcher and continuous batcher, with the engine lock
held, before running it (``TPLink.announce``: one queue per follower, so
operations arrive in rank 0's order); each follower runs the same
operation on its own objects. Their collectives (the decoder's sums and
gathers) meet inside the operation, on a process group with a finite
timeout: a rank that misses one fails it instead of hanging.

Every rank draws the same tokens with no broadcast: the summed hidden
states and the gathered logits are the same bits on every rank (each
rank's share is computed once and copied), and each sampler's generator
is seeded from the request alike, so greedy, sampled, first-token and
speculative-acceptance draws agree and the ranks' caches stay equal.

Devices: ``mesh.placement`` (rank r on ``cuda:r`` with NCCL when the
host has N cards; all ranks on ``cuda:0`` with gloo when it has fewer;
gloo on the CPU). The backend is printed.
"""

from __future__ import annotations

import argparse
import os
import queue as queue_mod
import shutil
import tempfile
import threading
import traceback

import torch
import torch.distributed as dist


class TPLink:
    """Rank 0's end of tensor-parallel serving: the follower processes and
    the queues their operations go down."""

    def __init__(self, procs, queues, tmp_dir, mesh):
        self.procs, self.queues, self.mesh = procs, queues, mesh
        self._tmp = tmp_dir
        self._lock = threading.Lock()

    def announce(self, target: str, name: str, args: tuple,
                 streamed: bool) -> None:
        """Send operation ``name`` of ``target`` ("server", "batcher" or
        "micro") with its host arguments to every follower. Callers hold
        the engine lock, so the followers see rank 0's order."""
        with self._lock:
            for q in self.queues:
                q.put((target, name, args, streamed))

    def close(self, timeout: float = 60.0) -> None:
        """Stop the followers (each leaves the process group) and leave
        it."""
        with self._lock:
            for q in self.queues:
                q.put(None)
        for p in self.procs:
            p.join(timeout)
            if p.is_alive():
                p.kill()
                p.join()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self._tmp, ignore_errors=True)


def _setup(rank: int, world: int, init_method: str, args):
    """Join the world, make the (1, world) mesh and build this rank's
    sharded engine and its config: the weights ``load_model`` gives for
    ``args`` (the same on every rank), the decoder sharded."""
    from visionselector_tpu_torch.api.predict import load_model, make_engine
    from visionselector_tpu_torch.core.mesh import (
        init_world,
        make_mesh,
        placement,
        tensor_parallel,
    )

    device, backend = placement(args.device, rank, world)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # "cuda" below is this rank's card
    init_world(rank, world, init_method, backend)
    mesh = make_mesh(1, world, device=device, backend=backend)
    cfg, params = load_model(args.family, args.model_path, device.type,
                             quantize=args.quantize)
    cfg, params = tensor_parallel(cfg, params, mesh)
    engine = make_engine(args.family, cfg, params, args.method, args.budget,
                         device.type)
    return mesh, engine


def start(args):
    """Rank 0's side of ``--tp N``: build the kernels once (on the card),
    spawn the N - 1 followers and join the world. Returns (TPLink, this
    rank's sharded engine)."""
    import torch.multiprocessing as mp

    from visionselector_tpu_torch.api.predict import load_config
    from visionselector_tpu_torch.models.qwen25vl.lm import tp_text_config

    world = int(args.tp)
    # a split that does not divide raises ValueError before any rank starts
    tp_text_config(load_config(args.family, args.model_path).text, world)
    if args.device == "cuda":  # once here, not in every rank
        from visionselector_tpu_torch.kernels import _build

        _build.load()
    tmp = tempfile.mkdtemp(prefix="vst_tp_")
    init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    ctx = mp.get_context("spawn")
    fields = dict(vars(args))
    queues, procs = [], []
    for rank in range(1, world):
        q = ctx.Queue()
        p = ctx.Process(target=follow,
                        args=(rank, world, init_method, fields, q),
                        daemon=True)
        p.start()
        queues.append(q)
        procs.append(p)
    try:
        mesh, engine = _setup(0, world, init_method, args)
    except BaseException:
        for p in procs:
            p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    print(f"[serve] tensor parallel over {world} ranks: backend "
          f"{mesh.backend}, rank 0 on {mesh.device}", flush=True)
    return TPLink(procs, queues, tmp, mesh), engine


def follow(rank: int, world: int, init_method: str, fields: dict,
           q) -> None:
    """A follower rank: the sharded engine and a Server without HTTP or
    worker threads, then rank 0's operations in order until told to stop
    (or until rank 0's process is gone). An operation that raises here
    raised on rank 0 too (the same host code on the same values): it is
    printed and the loop goes on."""
    import multiprocessing

    from visionselector_tpu_torch.api.serve import server_for
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        unwire_item,
    )

    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    args = argparse.Namespace(**fields)
    mesh, engine = _setup(rank, world, init_method, args)
    srv = server_for(args, engine, None, follower=True)
    targets = {"server": srv, "batcher": srv.batcher, "micro": srv.batcher}
    parent = multiprocessing.parent_process()
    with torch.no_grad():
        while True:
            try:
                msg = q.get(timeout=1.0)
            except queue_mod.Empty:
                if parent is not None and not parent.is_alive():
                    break
                continue
            if msg is None:
                break
            target, name, op_args, streamed = msg
            obj = targets[target]
            try:
                if target == "server":
                    obj._run(name, *op_args, on_token_chunk=(
                        (lambda tokens: None) if streamed else None))
                elif target == "batcher":
                    obj._op(name, *(unwire_item(a) if isinstance(a, dict)
                                    else a for a in op_args))
                else:
                    obj.run_batch(*op_args)
            except Exception:  # noqa: BLE001 — rank 0 reports it
                print(f"[serve tp rank {rank}] {target}.{name} raised:\n"
                      f"{traceback.format_exc()}", flush=True)
    dist.destroy_process_group()
