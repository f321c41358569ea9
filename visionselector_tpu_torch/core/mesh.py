"""The port's device mesh on ``torch.distributed`` (the reference's
``visionselector_tpu.core.mesh``).

A ``Mesh`` lays the ranks of the default process group out as a
(data, model) grid, as the reference reshapes its devices: rank r sits at
(r // n_model, r % n_model). Each rank holds the process group of its
line along each axis (``mesh.groups["model"]``: the ranks of its row) and
an explicit device and backend: NCCL where each rank owns a GPU, gloo on
the CPU or where ranks share one GPU. The collectives are in
``core.collectives``.

The reference leaves layouts to GSPMD; here each rank holds its own slice
of a sharded tensor, on the axis ``param_sharding_rules`` gives
(``shard_params`` for any tree; ``lm.shard_lm``, which tensor-parallel
serving runs, for the decoder), and the forwards that use them say where
they gather or sum (``lm.shard_lm`` / ``tensor_parallel``,
``lm.moe_mlp_ep``, ``vit.vit_forward_sp``).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# A finite timeout for every process group a mesh makes: a rank that
# misses a collective fails it loudly instead of hanging.
TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (data, model) grid of ranks."""

    shape: dict  # {"data": n_data, "model": n_model}
    rank: int  # in the default group
    device: torch.device
    backend: str
    groups: dict  # axis -> this rank's process group along it

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        d, m = divmod(self.rank, self.shape["model"])
        return d if axis == "data" else m


def init_world(rank: int, world: int, init_method: str, backend: str,
               timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the default process group (``init_method``: ``tcp://host:port``
    or ``file://path``) with a finite ``timeout``."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *, device,
              backend: Optional[str] = None) -> Mesh:
    """The (n_data, n_model) mesh over the default process group (every
    rank calls this, in the same order: each line's group is made on all
    ranks). ``n_data`` defaults to world // n_model; the product must be
    the world size (ValueError)."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"make_mesh: {n_data} x {n_model} ranks for a "
                         f"world of {world}")
    backend = backend or dist.get_backend()
    grid = np.arange(world).reshape(n_data, n_model)
    rank = dist.get_rank()
    groups = {}
    for axis, lines in (("model", grid), ("data", grid.T)):
        for line in lines:
            g = dist.new_group([int(r) for r in line], timeout=TIMEOUT,
                               backend=backend)
            if rank in line:
                groups[axis] = g
    return Mesh({"data": n_data, "model": n_model}, rank,
                torch.device(device), backend, groups)


# Sharded axis rules, by substring of the leaf name (the reference's
# param_sharding_rules): column-parallel kernels shard their last (output)
# axis, row-parallel ones their input axis; MoE expert kernels fall through
# to these rules too and shard their INTERMEDIATE axis, not the expert axis.
_COLUMN = ("gate_kernel", "up_kernel", "qkv_kernel", "q_kernel", "k_kernel",
           "v_kernel", "fc1_kernel")
_ROW = ("down_kernel", "o_kernel", "proj_kernel", "fc2_kernel")


def param_sharding_rules(name: str, ndim: int) -> Optional[int]:
    """The axis of a leaf named ``name`` (any separator; the reference's
    paths or the port's module names) with ``ndim`` dims that the "model"
    axis shards, or None for a replicated leaf: embeddings their vocab
    rows, the lm head its vocab columns, q / k / v / qkv / gate / up
    kernels their output axis, o / proj / down their input axis,
    everything else (norms, biases, routers, the scorer) none. The
    reference stacks layers on a leading axis and the port does not, so
    compare axes counted from the end."""
    if ndim == 0:
        return None
    last = ndim - 1
    if "embed_tokens" in name:
        return 0
    if "lm_head" in name:
        return last
    if any(k in name for k in _COLUMN):
        return last if ndim >= 2 else None
    if any(k in name for k in _ROW):
        return last - 1 if ndim >= 2 else None
    return None


def local_slice(t: torch.Tensor, axis: int, index: int,
                n: int) -> torch.Tensor:
    """Part ``index`` of ``n`` equal contiguous parts of ``t`` along
    ``axis`` (a view)."""
    size = t.shape[axis] // n
    return t.narrow(axis, index * size, size)


def shard_params(params, mesh: Mesh, qkv_heads: Optional[int] = None,
                 axis: str = "model") -> dict:
    """This rank's local tensors of ``params`` (an ``nn.Module``'s
    parameters and buffers, or a name -> tensor dict) under
    ``param_sharding_rules``: part ``mesh.index(axis)`` of each sharded
    leaf, contiguous, and the whole leaf where the sharded dim does not
    divide the axis size (the reference's replication fallback).

    Departure from a contiguous split: a ViT ``qkv_kernel`` (``qkv_heads``
    given) is the [in, 3 * H * dp] slab of q, k and v, so it splits by
    heads (each rank's q, k and v columns of heads [h0, h1)), where the
    reference's GSPMD layout cuts the slab into contiguous column blocks.
    """
    named = (dict(params.named_parameters()) | dict(params.named_buffers())
             if isinstance(params, torch.nn.Module) else dict(params))
    n, i = mesh.size(axis), mesh.index(axis)
    out = {}
    for name, t in named.items():
        ax = param_sharding_rules(name, t.dim())
        if ax is None or t.shape[ax] % n:
            out[name] = t
        elif "qkv_kernel" in name and qkv_heads and qkv_heads % n == 0:
            slab = t.unflatten(-1, (3, qkv_heads, -1))
            out[name] = local_slice(slab, -2, i, n).flatten(-3).contiguous()
        else:
            out[name] = local_slice(t, ax, i, n).contiguous()
    return out


def batch_sharding(mesh: Mesh):
    """Data sharding of a batch (the reference's ``batch_sharding``): a
    function giving this rank's part of a leaf along axis 0 (its
    ``mesh.index("data")``-th of ``n_data`` parts); 0-d leaves whole."""
    def local(leaf):
        if getattr(leaf, "ndim", 0) < 1:
            return leaf
        return local_slice(leaf, 0, mesh.index("data"), mesh.size("data"))

    return local


def accum_batch_sharding(mesh: Mesh):
    """Data sharding of an accumulation batch [A, B, ...] (the reference's
    ``accum_batch_sharding``): the micro-step axis A whole, the batch axis
    B split over "data"; leaves of fewer than 2 dims whole."""
    def local(leaf):
        if getattr(leaf, "ndim", 0) < 2:
            return leaf
        return local_slice(leaf, 1, mesh.index("data"), mesh.size("data"))

    return local


def tensor_parallel(cfg, params, mesh: Mesh, axis: str = "model"):
    """A tensor-parallel engine's (config, parameters) on this rank: the
    decoder sharded in place over ``axis`` (``lm.shard_lm``), the vision
    tower and the scorer replicated. Returns the config with the
    rank-local ``TextConfig`` and ``params``."""
    from visionselector_tpu_torch.models.qwen25vl.lm import shard_lm

    shard_lm(params.lm, mesh, axis)
    return dataclasses.replace(cfg, text=params.lm.cfg), params
