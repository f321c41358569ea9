"""The collectives of the port's parallel paths, in one module: sum over a
group (``all_reduce``), concatenation along a dim (``all_gather``) and
JAX's ``ppermute`` (``ppermute``: each rank sends to at most one rank and
receives from at most one), on ``torch.distributed`` process groups
(``core.mesh``). Nothing broadcasts: tensor-parallel ranks agree on every
sampled token because they draw it from the same bits
(``api.serve_tp``).

A tensor that carries a gradient goes through
``torch.distributed.nn.functional`` in ``all_reduce`` / ``all_gather``
(the gradient of a sum is a sum, of a gather a slice); otherwise the
in-place ``torch.distributed`` call. ``ppermute`` carries no gradient:
the pipeline (``core.pipeline``) calls it inside one autograd Function
whose backward runs the reverse permutation itself.

Backends: NCCL where each rank owns a GPU, gloo on the CPU and where ranks
share one GPU (NCCL refuses two ranks on one device). On the H100 (torch
2.11) gloo ran all_reduce and all_gather on CUDA tensors directly, so
those stage nothing through the host; gloo's send and recv take CPU
tensors only, so ``ppermute`` copies through the host under gloo.
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



def ppermute(t: torch.Tensor, perm, group, backend: str) -> torch.Tensor:
    """JAX's ``lax.ppermute`` over ``group``: ``perm`` lists (source,
    destination) pairs of group ranks; each rank sends ``t`` to its
    destination and returns what its source sent (zeros where it has
    none). Every rank of the group calls it with the same ``perm`` and
    shapes. Under gloo (``backend``, the mesh's) the operands are host
    copies; under NCCL the device tensors."""
    me = dist.get_rank(group)
    host = backend == "gloo" and t.device.type != "cpu"
    send = t.detach().contiguous()
    if host:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops, receives = [], False
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(group, dst), group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, recv,
                                  dist.get_global_rank(group, src), group))
            receives = True
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if not receives:
        return torch.zeros_like(t)
    return recv.to(t.device) if host else recv
