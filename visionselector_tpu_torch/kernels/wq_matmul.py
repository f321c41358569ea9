"""Weight-only quantized matrix product: the CUDA kernel for decode rows
and its plain PyTorch version.

Replaces no TPU kernel. The reference's ``_dense``
(``visionselector_tpu.models.qwen25vl.lm``) keeps its decoder kernels as
int8 or packed int4 in device memory and leaves the convert to XLA, which
fuses it into the dot's operand read; in PyTorch ``x @ w.to(bf16)`` writes
a bf16 copy of the weight and reads it back. ``wq_matmul`` (the kernel,
``csrc/wq_matmul_fwd.cu``) widens the stored bits in registers instead;
``wq_matmul_plain`` computes the same function by dequantizing first.

Weights: int8 ``[K, N]`` or packed int4 uint8 ``[K, N / 2]`` (``lm.pack_int4``
along the output axis: byte j holds column 2j in its low nibble), with fp32
scales ``[N]`` (per output channel) or, with int4, ``[G, N]`` (one row per
K / G inputs). Per channel ``y = (x @ q) * s``, grouped ``y = x @ (q * s_g)``,
both in x's dtype (the reference's order).

Routes (``lm._dense`` picks one per call): on a CUDA bf16 tensor with at
most ``WQ_MAX_ROWS[w.dtype]`` rows and no gradient to carry, the kernel
(``WQ_LAUNCHES``); other CUDA calls, prefill rows or a product under grad,
dequantize the layer's kernel into a bf16 transient and take
``torch.matmul`` (``WQ_DEQUANT_CALLS``), so a gradient reaches x by plain
autograd; CPU tensors take ``wq_matmul_plain``. The row cap follows the
stored format, from the two routes' times at 16 and 32 rows on the H100
(PERF.md §6): int8 16 (the kernel ties the dequantize route at 16 rows and
takes twice its time at 32), packed int4 32 (the kernel is faster at both:
dequantizing int4 costs more). An empty ``WQ_MAX_ROWS`` sends every product
to the dequantize route.
"""

from __future__ import annotations

import torch

# Most x rows the kernel takes (its accumulators), and the most the model
# sends it for each stored dtype (int8, packed int4): more rows take the
# dequantize route.
WQ_KERNEL_ROWS = 32
WQ_MAX_ROWS = {torch.int8: 16, torch.uint8: 32}

# Calls that launched the kernel, and CUDA calls that took the dequantize
# route. Plain ints: count from one thread at a time.
WQ_LAUNCHES = 0
WQ_DEQUANT_CALLS = 0

QUANT_DTYPES = (torch.int8, torch.uint8)


def weight_ints(w: torch.Tensor) -> torch.Tensor:
    """The integer values of a stored kernel: int8 as it is, packed int4
    unpacked (``lm.unpack_int4``; int8 [K, N] either way)."""
    if w.dtype != torch.uint8:
        return w
    from visionselector_tpu_torch.models.qwen25vl.lm import unpack_int4

    return unpack_int4(w)


def dequantize(w: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The [K, N] weight in ``dtype`` as the product reads it: per channel
    the integers themselves (the scale multiplies the product's result),
    grouped ``q * s_g`` rounded to ``dtype``."""
    q = weight_ints(w).to(dtype)
    if scale.dim() == 1:
        return q
    g, n = scale.shape
    return (q.view(g, -1, n) * scale[:, None, :].to(dtype)).view(q.shape)


def wq_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """x [.., K] @ the quantized kernel, in x's dtype: ``(x @ q) * s`` per
    channel, ``x @ (q * s_g)`` grouped (the reference's ``_dense``)."""
    y = x @ dequantize(w, scale, x.dtype)
    if scale.dim() == 1:
        y = y * scale.to(x.dtype)
    return y


def wq_dequant_matmul(x: torch.Tensor, w: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The route for prefill rows and products under grad: the layer's
    kernel dequantized into a transient, then ``torch.matmul``
    (``wq_matmul_plain``), counted in ``WQ_DEQUANT_CALLS`` on the card."""
    global WQ_DEQUANT_CALLS
    if x.is_cuda:
        WQ_DEQUANT_CALLS += 1
    return wq_matmul_plain(x, w, scale)


def _check(x, w, scale):
    if x.dim() < 1 or not x.is_cuda:
        raise ValueError("wq_matmul_fwd: x must be a CUDA tensor")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"wq_matmul_fwd: x must be bfloat16, got {x.dtype}")
    if w.dtype not in QUANT_DTYPES or w.dim() != 2:
        raise ValueError(f"wq_matmul_fwd: the weight must be int8 [K, N] or "
                         f"packed int4 uint8 [K, N / 2], got {w.dtype} "
                         f"{tuple(w.shape)}")
    if scale.dtype != torch.float32 or scale.dim() not in (1, 2):
        raise ValueError(f"wq_matmul_fwd: scales must be f32 [N] or [G, N], "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    for t, name in ((w, "weight"), (scale, "scale")):
        if t.device != x.device:
            raise ValueError(f"wq_matmul_fwd: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"wq_matmul_fwd: {name} must be contiguous")
    k, n = w.shape[0], scale.shape[-1]
    if x.shape[-1] != k or w.shape[1] * (2 if w.dtype == torch.uint8
                                          else 1) != n:
        raise ValueError(f"wq_matmul_fwd: x {tuple(x.shape)}, weight "
                         f"{tuple(w.shape)} {w.dtype} and scales "
                         f"{tuple(scale.shape)} do not match")
    if scale.dim() == 2 and (scale.shape[0] < 1 or k % scale.shape[0]
                             or w.dtype != torch.uint8):
        raise ValueError(f"wq_matmul_fwd: {scale.shape[0]} groups of a "
                         f"{w.dtype} weight with K = {k}; groups come only "
                         f"with packed int4 and divide K")
    return k, n


def _launch(x, w, scale, fault: int = 0):
    """One launch of the kernel (CUDA tensors). ``fault`` plants an error
    for the checks (1: the last k chunk skipped, 2: int4 nibbles swapped,
    3: group g read with group g + 1's scale); the model passes 0."""
    global WQ_LAUNCHES
    k, n = _check(x, w, scale)
    rows = x.numel() // k
    if not 1 <= rows <= WQ_KERNEL_ROWS:
        raise ValueError(f"wq_matmul_fwd: {rows} rows; the kernel takes 1 to "
                         f"{WQ_KERNEL_ROWS}")
    x2 = x.reshape(rows, k).contiguous()
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    bits = 4 if w.dtype == torch.uint8 else 8
    group = k // scale.shape[0] if scale.dim() == 2 else 0
    from visionselector_tpu_torch.kernels import _build

    err = _build.load().vst_wq_matmul_fwd(
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(),
        rows, k, n, bits, group, int(fault),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"wq_matmul_fwd launch failed: CUDA error {err}")
    WQ_LAUNCHES += 1
    return y.reshape(*x.shape[:-1], n)


def wq_matmul(x: torch.Tensor, w: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x [.., K] @ the quantized kernel: the CUDA kernel for a CUDA tensor
    (at most ``WQ_KERNEL_ROWS`` rows, bf16; anything else raises), the
    plain version for a CPU tensor. The kernel's output carries no
    gradient: ``lm._dense`` sends products under grad to
    ``wq_dequant_matmul``."""
    if not x.is_cuda:
        return wq_matmul_plain(x, w, scale)
    return _launch(x, w, scale)


def bytes_moved(rows: int, w: torch.Tensor, scale: torch.Tensor) -> int:
    """The bytes one call must move: the stored weight, its scales, x and
    y (bf16), each once. Over 3.35 TB/s this is the kernel's bound."""
    n = scale.shape[-1]
    return (w.numel() * w.element_size() + scale.numel() * 4
            + 2 * rows * w.shape[0] + 2 * rows * n)
