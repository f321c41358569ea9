"""The port's device mesh on ``torch.distributed`` (the reference's
``visionselector_tpu.core.mesh``).

A ``Mesh`` lays ranks [0, n) of the default process group out as a grid
of named axes, row-major, as the reference reshapes its devices: a
(data, model) grid puts rank r at (r // n_model, r % n_model), and the
pipeline's 1-D "stage" grid puts it at stage r. Each rank holds the
process group of its line along each axis (``mesh.groups["model"]``: the
ranks of its row) and an explicit device and backend (``placement``):
NCCL where each rank owns a GPU, gloo on the CPU or where ranks share one
GPU. A grid smaller than the world leaves the ranks past it idle, as the
reference's training leaves ``devices[n_data:]`` out of its mesh. The
collectives are in ``core.collectives``.

The reference leaves layouts to GSPMD; here each rank holds its own slice
of a sharded tensor, on the axis ``param_sharding_rules`` gives
(``shard_params`` for any tree; ``lm.shard_lm``, which tensor-parallel
serving runs, for the decoder; ``pipeline.stage_layers`` for the
pipeline's layer stack), and the forwards that use them say where they
gather or sum (``lm.shard_lm`` / ``tensor_parallel``, ``lm.moe_mlp_ep``,
``vit.vit_forward_sp``, ``pipeline.gpipe``).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# A finite timeout for every process group a mesh makes: a rank that
# misses a collective fails it loudly instead of hanging.
TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass
class Mesh:
    """This rank's view of a grid of ranks: ``shape`` maps each axis to
    its size, in grid order."""

    shape: dict  # {"data": n_data, "model": n_model} or {"stage": n}
    rank: int  # in the default group
    device: torch.device
    backend: str
    groups: dict  # axis -> this rank's process group along it

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        coords = np.unravel_index(self.rank, tuple(self.shape.values()))
        return int(coords[list(self.shape).index(axis)])


def placement(device: str, rank: int, world: int):
    """(device, backend) of ``rank`` of ``world`` ranks on this host: rank
    r on ``cuda:r`` with NCCL when the host has a card for every rank;
    every rank on ``cuda:0`` with gloo when it has fewer (NCCL refuses two
    ranks on one device); gloo on the CPU."""
    if device == "cuda":
        if torch.cuda.device_count() >= world:
            return torch.device("cuda", rank), "nccl"
        return torch.device("cuda", 0), "gloo"
    return torch.device("cpu"), "gloo"


def init_world(rank: int, world: int, init_method: str, backend: str,
               timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the default process group (``init_method``: ``tcp://host:port``,
    ``file://path`` or ``env://``) with a finite ``timeout``."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)


def grid_mesh(shape: dict, *, device,
              backend: Optional[str] = None) -> Optional[Mesh]:
    """The mesh of ``shape`` (axis -> size, in grid order) over ranks
    [0, prod(sizes)) of the default process group. Every rank of the
    world calls this, in the same order (each line's group is made on all
    ranks); ranks past the grid get None. ValueError when the grid needs
    more ranks than the world has."""
    world = dist.get_world_size()
    n = math.prod(shape.values())
    if n > world:
        raise ValueError(f"a {' x '.join(map(str, shape.values()))} mesh "
                         f"needs {n} ranks; the world has {world}")
    backend = backend or dist.get_backend()
    grid = np.arange(n).reshape(tuple(shape.values()))
    rank = dist.get_rank()
    groups = {}
    for ax, axis in enumerate(shape):
        for line in np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax]):
            g = dist.new_group([int(r) for r in line], timeout=TIMEOUT,
                               backend=backend)
            if rank in line:
                groups[axis] = g
    if rank >= n:
        return None
    return Mesh(dict(shape), rank, torch.device(device), backend, groups)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, *, device,
              backend: Optional[str] = None) -> Optional[Mesh]:
    """The (n_data, n_model) mesh over ranks [0, n_data * n_model) of the
    default process group (``grid_mesh``). ``n_data`` defaults to
    world // n_model."""
    if n_data is None:
        n_data = dist.get_world_size() // n_model
    return grid_mesh({"data": n_data, "model": n_model}, device=device,
                     backend=backend)


def data_mesh(batch_size: int, *, device,
              backend: Optional[str] = None) -> Optional[Mesh]:
    """Data-parallel training's mesh (the reference's ``api/train.py``):
    (gcd(batch_size, world), 1) over the first n_data ranks, so every rank
    holds an equal part of the batch; None on the ranks past it."""
    n_data = math.gcd(batch_size, dist.get_world_size())
    return make_mesh(n_data, 1, device=device, backend=backend)


def stage_mesh(n_stages: Optional[int] = None, *, device,
               backend: Optional[str] = None) -> Optional[Mesh]:
    """The pipeline's 1-D "stage" mesh over ranks [0, n_stages) (default:
    the whole world), the reference's ``Mesh(devices, ("stage",))``."""
    return grid_mesh({"stage": n_stages or dist.get_world_size()},
                     device=device, backend=backend)


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


def local_slice(t, axis: int, index: int, n: int):
    """Part ``index`` of ``n`` equal contiguous parts of ``t`` (a tensor
    or a numpy array) along ``axis`` (a view)."""
    size = t.shape[axis] // n
    at = axis % t.ndim
    return t[(slice(None),) * at + (slice(index * size,
                                          (index + 1) * size),)]


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


def tensor_parallel(cfg, params, mesh: Mesh, axis: str = "model"):
    """A tensor-parallel engine's (config, parameters) on this rank: the
    decoder sharded in place over ``axis`` (``lm.shard_lm``), the vision
    tower and the scorer replicated. Returns the config with the
    rank-local ``TextConfig`` and ``params``."""
    from visionselector_tpu_torch.models.qwen25vl.lm import shard_lm

    shard_lm(params.lm, mesh, axis)
    return dataclasses.replace(cfg, text=params.lm.cfg), params
