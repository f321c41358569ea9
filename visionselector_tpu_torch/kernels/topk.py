"""Differentiable (training) and hard (inference) top-k.

Counterpart of ``visionselector_tpu.kernels.topk``:

- ``soft_topk``: per row, the threshold t with sum(sigmoid(x + t)) == k
  by a fixed 64-step bisection (fp32), p = sigmoid(x + t); its backward is
  the analytic VJP of the implicit function, -(sum g v) v / s + g v with
  v = sigmoid'(x + t), s = sum v. No gradient for k.
- ``stable_topk``: the k largest values along the last dim and their
  indices, ties broken toward the lower index (``jax.lax.top_k``'s
  order). The order comes from a stable sort of the negated values:
  ``torch.topk`` does not promise an order among ties on CUDA.
- ``hard_topk_indices`` / ``hard_topk_mask``: ``stable_topk``'s indices
  then an ascending sort, padded to a static ``k_max``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _find_ts(xs: torch.Tensor, k, iters: int = 64) -> torch.Tensor:
    """Per-row threshold t with sum(sigmoid(x + t)) == k by bisection.
    xs: [B, N] (computed in fp32, or fp64 for fp64 input); k: scalar or
    [B]. Returns [B, 1]."""
    k = torch.as_tensor(k, dtype=xs.dtype, device=xs.device)
    k = k.expand(xs.shape[0])
    lo = -xs.amax(dim=1, keepdim=True) - 10.0
    hi = -xs.amin(dim=1, keepdim=True) + 10.0
    for _ in range(iters):
        mid = (hi + lo) / 2.0
        too_small = (torch.sigmoid(xs + mid).sum(dim=1) < k)[:, None]
        lo = torch.where(too_small, mid, lo)
        hi = torch.where(too_small, hi, mid)
    return (lo + hi) / 2.0


class SoftTopK(torch.autograd.Function):
    """p = sigmoid(x + t(x)) with sum(p) == k per row (see ``soft_topk``)."""

    @staticmethod
    def forward(ctx, xs, k, iters):
        xf = xs.to(torch.promote_types(xs.dtype, torch.float32))
        ts = _find_ts(xf, k, iters)
        ctx.save_for_backward(xf, ts)
        ctx.in_dtype = xs.dtype
        return torch.sigmoid(xf + ts)

    @staticmethod
    def backward(ctx, g):
        xf, ts = ctx.saved_tensors
        sig = torch.sigmoid(xf + ts)
        v = sig * (1.0 - sig)  # sigmoid'(x + t)
        s = v.sum(dim=1, keepdim=True)
        uv = g * v
        dx = -uv.sum(dim=1, keepdim=True) * v / s + uv
        return dx.to(ctx.in_dtype), None, None


def soft_topk(xs: torch.Tensor, k, iters: int = 64) -> torch.Tensor:
    """Differentiable top-k mask. xs: [B, N] scores; k: scalar or [B]
    (float allowed; no gradient). Returns [B, N] soft membership mass in
    fp32 (fp64 for fp64 scores), summing to k per row."""
    return SoftTopK.apply(xs, k, iters)


def stable_topk(x: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last dim, largest
    first, ties toward the lower index. The values are gathered from x, so
    they carry its gradient; the indices are int64."""
    idx = torch.sort(-x, dim=-1, stable=True).indices[..., :k]
    return x.gather(-1, idx), idx


def hard_topk_indices(scores: torch.Tensor, k: int, k_max: int,
                      valid_len: int | None = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k indices (ascending) with a static output size.

    scores: [N] (padding rows may hold any value); 1 <= k <= k_max; rows >=
    valid_len are excluded. Returns (indices [k_max] int32 ascending —
    slots >= k hold the sentinel N, valid [k_max] bool).
    """
    n = scores.shape[0]
    s = scores.float()
    if valid_len is not None:
        row_ok = torch.arange(n, device=s.device) < valid_len
        s = torch.where(row_ok, s, float("-inf"))
    order = stable_topk(s, k_max)[1]
    keep = torch.arange(k_max, device=s.device) < k
    idx = torch.sort(torch.where(keep, order, n)).values
    return idx.to(torch.int32), idx < n


def hard_topk_mask(scores: torch.Tensor, k: int, k_max: int,
                   valid_len: int | None = None) -> torch.Tensor:
    """0/1 fp32 mask [N] of the hard top-k selection."""
    idx, valid = hard_topk_indices(scores, k, k_max, valid_len)
    mask = torch.zeros(scores.shape[0] + 1, dtype=torch.float32,
                       device=scores.device)
    mask[idx.long()] = valid.float()  # invalid slots all hit row N, dropped
    return mask[:-1]
