"""The collectives of the port's parallel paths, in one module: sum over a
group (``all_reduce``) and concatenation along a dim (``all_gather``), on
``torch.distributed`` process groups (``core.mesh``). Nothing broadcasts:
tensor-parallel ranks agree on every sampled token because they draw it
from the same bits (``api.serve_tp``).

A tensor that carries a gradient goes through
``torch.distributed.nn.functional`` (the gradient of a sum is a sum, of a
gather a slice); otherwise the in-place ``torch.distributed`` call.

Backends: NCCL where each rank owns a GPU, gloo on the CPU and where ranks
share one GPU (NCCL refuses two ranks on one device). On the H100 (torch
2.11) gloo ran all_reduce and all_gather on CUDA tensors
directly, so no collective stages through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (every rank gets it)."""
    if _grad(t):
        import torch.distributed.nn.functional as dnn

        return dnn.all_reduce(t, group=group)
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (JAX's
    ``all_gather(..., tiled=True)``); every rank's ``t`` has one shape."""
    n = dist.get_world_size(group)
    if _grad(t):
        import torch.distributed.nn.functional as dnn

        return torch.cat(dnn.all_gather(t, group=group), dim=dim)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)

