"""Weight-only quantized matrix products: the CUDA kernels and their plain
PyTorch versions.

Replaces no TPU kernel. The reference's ``_dense``
(``visionselector_tpu.models.qwen25vl.lm``) keeps its decoder kernels as
int8 or packed int4 in device memory and leaves the convert to XLA, which
fuses it into the dot's operand read; in PyTorch ``x @ w.to(bf16)`` writes
a bf16 copy of the weight and reads it back. Two hand-written kernels
(``csrc/wq_matmul_fwd.cu``) stand in for that fusion:

- ``wq_matmul`` (kernel A, ``wq_matmul_fwd``): the product for decode
  rows (1 to ``WQ_KERNEL_ROWS``), the stored bits widened in registers and
  fed to the tensor cores. Bound by the bytes: the stored weight, its
  scales, x and y, each once, over 3.35 TB/s (the 3B decoder layer's seven
  products: 0.0231 ms int8, 0.0116 int4). Each product is cut into column
  tiles and K splits by ``wq_plan`` so that it launches at least one block
  per SM (132), and two where K, the group size and a cluster's 16 blocks
  allow; a block's four warps split its k rows again, each streaming its
  weight and x tiles through a 4-stage ``cp.async`` ring in shared memory.
  The K splits of a column tile are one thread-block cluster: their fp32
  partial sums meet through distributed shared memory and add in split
  order (no workspace, no float atomics, the same sum every run).
- ``wq_dequant`` (kernel B, ``wq_dequant_fwd``): for prefill rows and
  products under grad, the stored weight and its scales read once and the
  bf16 transient ``[K, N]`` written in one pass, bit-equal to
  ``dequantize``; the product after it stays ``torch.matmul``. Bound by
  the bytes: stored weight + scales + the transient (3 bytes a weight for
  int8, 2.5 for int4 in bf16: 0.069 / 0.057 ms for a 3B layer).

Weights: int8 ``[K, N]`` or packed int4 uint8 ``[K, N / 2]`` (``lm.pack_int4``
along the output axis: byte j holds column 2j in its low nibble), with fp32
scales ``[N]`` (per output channel) or, with int4, ``[G, N]`` (one row per
K / G inputs). Per channel ``y = (x @ q) * s``, grouped ``y = x @ (q * s_g)``,
both in x's dtype (the reference's order).

Routes (``lm._dense`` picks one per call, ``use_kernel``): a CUDA bf16 x
with at most ``WQ_MAX_ROWS[w.dtype]`` rows, no gradient to carry and a
shape the kernel takes (``wq_plan``: K a multiple of 8, a group a multiple
of 16) takes kernel A (``WQ_LAUNCHES``); every other CUDA call takes the
dequantize route (``wq_dequant_matmul``, counted in ``WQ_DEQUANT_CALLS``:
kernel B, ``WQ_DEQUANT_LAUNCHES``, then ``torch.matmul``), so a gradient
reaches x by plain autograd; CPU tensors take the plain versions. The row
caps follow each format's crossover against the dequantize route at 16,
32 and 64 rows on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``
16(a), PERF.md §6): the 3B decoder layer's seven products, kernel A /
the dequantize route, in ms. Kernel A is faster up to 32 rows and slower
at 64 in every format, so both caps are 32: an 8-slot speculative
verify chunk at m = 3 (32 rows) takes kernel A, at m = 7 (64 rows) the
dequantize route.

================  ===============  ===============  ===============
format            16 rows          32 rows          64 rows
================  ===============  ===============  ===============
int8              0.1218 / 0.2259  0.1621 / 0.2280  0.2408 / 0.2322
int4              0.0957 / 0.2154  0.1413 / 0.2186  0.2312 / 0.2239
int4:g128         0.1043 / 0.1855  0.1578 / 0.1876  0.2411 / 0.1922
================  ===============  ===============  ===============

An empty ``WQ_MAX_ROWS`` sends every product to the dequantize route.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

# Most x rows kernel A takes (its row tiles: 8, 16, 32, 64), and the most
# the model sends it for each stored dtype (int8, packed int4): more rows
# take the dequantize route (the table above).
WQ_KERNEL_ROWS = 64
WQ_MAX_ROWS = {torch.int8: 32, torch.uint8: 32}

# Calls that launched kernel A; CUDA calls that took the dequantize route;
# launches of kernel B (one per such call). Plain ints: count from one
# thread at a time.
WQ_LAUNCHES = 0
WQ_DEQUANT_CALLS = 0
WQ_DEQUANT_LAUNCHES = 0

QUANT_DTYPES = (torch.int8, torch.uint8)

# Kernel A's launch geometry (csrc/wq_matmul_fwd.cu mirrors these).
WQ_SMS = 132           # the H100's SMs: a plan launches at least this many
WQ_TARGET_BLOCKS = 2 * WQ_SMS  # ... and this many where the shape allows
WQ_WARPS = 4           # warps a block, splitting its k rows
WQ_STAGES = 4          # the cp.async ring's stages, per warp
WQ_STAGE_ROWS = 32     # k rows a stage holds
WQ_SPLIT_ROWS = 64     # least k rows of a split (per channel; a group else)
WQ_MAX_SPLITS = 16     # K splits of a column tile: one cluster's blocks
WQ_ROW_TILES = (8, 16, 32, 64)
# Columns a lane (column tile = 8 lanes x this), widest first; a row tile
# takes those up to its widest (128-byte tile rows where a lane's
# CT * row_tile / 4 accumulators stay within 128 registers).
WQ_LANE_COLS = (32, 16, 8, 2)
WQ_WIDEST_COLS = {8: {8: 16, 16: 16, 32: 16, 64: 8},
                  4: {8: 32, 16: 16, 32: 16, 64: 8}}


class WqPlan(NamedTuple):
    """How kernel A cuts one product: ``tiles`` column tiles of
    ``col_tile`` columns (``cols_per_thread`` a lane) times ``splits``
    K splits of ``split_rows`` rows (the last may be shorter; a column
    tile's splits are one cluster); one block of ``WQ_WARPS`` warps each,
    ``row_tile`` rows of x, ``smem`` dynamic shared bytes."""
    row_tile: int
    cols_per_thread: int
    col_tile: int
    tiles: int
    splits: int
    split_rows: int
    stages: int
    blocks: int
    smem: int


def plan_error(rows: int, k: int, n: int, bits: int, group: int):
    """Why kernel A does not take this product, or None."""
    if not 1 <= rows <= WQ_KERNEL_ROWS:
        return f"{rows} rows; the kernel takes 1 to {WQ_KERNEL_ROWS}"
    if bits not in (4, 8):
        return f"bits {bits}: the kernel takes 8 or 4"
    if k < 1 or n < 1:
        return f"empty product: K = {k}, N = {n}"
    if k % 8:
        return f"K = {k} is not a multiple of 8 (x's 16-byte copies)"
    if n % (4 if bits == 8 else 8):
        return (f"N = {n}: a stored row of {n * bits // 8} bytes is not a "
                f"multiple of 4")
    if group and (bits != 4 or group % 16 or k % group):
        return (f"group {group} with {bits}-bit weights and K = {k}: groups "
                f"come with int4, divide K and are a multiple of 16")
    return None


@functools.lru_cache(maxsize=None)
def wq_plan(rows: int, k: int, n: int, bits: int, group: int = 0) -> WqPlan:
    """Kernel A's plan for x [rows, k] @ a [k, n] weight of ``bits`` (4 or
    8) with per-channel scales (``group`` 0) or one per ``group`` inputs.
    Splits take whole units (``WQ_SPLIT_ROWS`` rows, a group under
    groups), so a block reads each of its scale rows once, and a column
    tile takes at most ``WQ_MAX_SPLITS``. The widest column tile
    (``WQ_LANE_COLS``) that can reach ``WQ_TARGET_BLOCKS`` blocks is taken,
    else the widest that can reach ``WQ_SMS``, else the narrowest (16
    columns); then units per split as many as keep the blocks at or above
    the target, balanced across the splits. Raises ValueError for a
    product the kernel does not take (``plan_error``)."""
    err = plan_error(rows, k, n, bits, group)
    if err:
        raise ValueError(f"wq_plan: {err}")
    unit = group or WQ_SPLIT_ROWS
    units = -(-k // unit)
    row_tile = next(t for t in WQ_ROW_TILES if rows <= t)
    options = [(ct, -(-n // (8 * ct))) for ct in WQ_LANE_COLS
               if ct <= WQ_WIDEST_COLS[bits][row_tile]]
    most = min(units, WQ_MAX_SPLITS)
    ct, tiles = next(
        (o for want in (WQ_TARGET_BLOCKS, WQ_SMS) for o in options
         if o[1] * most >= want), options[-1])
    per = max(1, -(-units // WQ_MAX_SPLITS),
              units * tiles // WQ_TARGET_BLOCKS)
    splits = -(-units // per)
    per = -(-units // splits)
    col_tile = 8 * ct
    ring = WQ_WARPS * WQ_STAGES * WQ_STAGE_ROWS * (col_tile * bits // 8
                                                   + 2 * row_tile)
    red = WQ_WARPS * row_tile * col_tile * 4
    return WqPlan(row_tile=row_tile, cols_per_thread=ct, col_tile=col_tile,
                  tiles=tiles, splits=splits, split_rows=per * unit,
                  stages=WQ_STAGES, blocks=tiles * splits,
                  smem=max(ring, red))


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
    grouped ``q * s_g`` rounded to ``dtype``. Kernel B's plain version."""
    q = weight_ints(w).to(dtype)
    if scale.dim() == 1:
        return q
    g, n = scale.shape
    return (q.view(g, -1, n) * scale[:, None, :].to(dtype)).view(q.shape)


def wq_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """x [.., K] @ the quantized kernel, in x's dtype: ``(x @ q) * s`` per
    channel, ``x @ (q * s_g)`` grouped (the reference's ``_dense``).
    Kernel A's plain version."""
    y = x @ dequantize(w, scale, x.dtype)
    if scale.dim() == 1:
        y = y * scale.to(x.dtype)
    return y


def _check(k_in: int, device, w, scale):
    """(K, N, bits, group) of a product whose x has ``k_in`` columns on
    ``device``, or ValueError."""
    if w.dtype not in QUANT_DTYPES or w.dim() != 2:
        raise ValueError(f"wq: the weight must be int8 [K, N] or packed int4 "
                         f"uint8 [K, N / 2], got {w.dtype} {tuple(w.shape)}")
    if scale.dtype != torch.float32 or scale.dim() not in (1, 2):
        raise ValueError(f"wq: scales must be f32 [N] or [G, N], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    for t, name in ((w, "weight"), (scale, "scale")):
        if t.device != device:
            raise ValueError(f"wq: {name} on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"wq: {name} must be contiguous")
    bits = 4 if w.dtype == torch.uint8 else 8
    k, n = w.shape[0], scale.shape[-1]
    if k_in != k or w.shape[1] * (8 // bits) != n:
        raise ValueError(f"wq: x of {k_in} columns, weight {tuple(w.shape)} "
                         f"{w.dtype} and scales {tuple(scale.shape)} do not "
                         f"match")
    if scale.dim() == 2 and (scale.shape[0] < 1 or k % scale.shape[0]
                             or bits != 4):
        raise ValueError(f"wq: {scale.shape[0]} groups of a {w.dtype} weight "
                         f"with K = {k}; groups come only with packed int4 "
                         f"and divide K")
    return k, n, bits, k // scale.shape[0] if scale.dim() == 2 else 0


def use_kernel(x: torch.Tensor, w: torch.Tensor,
               scale: torch.Tensor) -> bool:
    """Whether ``lm._dense`` sends this product to kernel A: a CUDA bf16 x
    of at most ``WQ_MAX_ROWS[w.dtype]`` rows that carries no gradient, and
    a shape ``wq_plan`` takes. Everything else takes the dequantize
    route."""
    if not (x.is_cuda and x.dtype == torch.bfloat16) or (
            torch.is_grad_enabled() and x.requires_grad):
        return False
    k = x.shape[-1]
    rows = x.numel() // k
    if rows > WQ_MAX_ROWS.get(w.dtype, 0):
        return False
    group = k // scale.shape[0] if scale.dim() == 2 else 0
    return plan_error(rows, k, scale.shape[-1],
                      4 if w.dtype == torch.uint8 else 8, group) is None


def _launch_args(x, w, scale, fault: int = 0, stream: int = 0):
    """Kernel A's output y, x as the kernel reads it (contiguous, 16-byte
    aligned: a copy where the view is not) and the C entry's arguments,
    for a product ``wq_plan`` takes. The launch needs no other memory."""
    k, n, bits, group = _check(x.shape[-1], x.device, w, scale)
    rows = x.numel() // k
    plan = wq_plan(rows, k, n, bits, group)
    x2 = x.reshape(rows, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    args = (x2.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(),
            rows, k, n, bits, group, plan.cols_per_thread, plan.row_tile,
            plan.tiles, plan.splits, plan.split_rows, int(fault), stream)
    return y, x2, args


def _launch(x, w, scale, fault: int = 0):
    """One launch of kernel A (CUDA tensors). ``fault`` plants an error for
    the checks (1: the last 16 k rows skipped, 2: int4 nibbles swapped,
    3: group g read with group g + 1's scale, 4: one K split's partial
    dropped: split 0's, or with one split warp 0's); the model passes 0."""
    global WQ_LAUNCHES
    if not x.is_cuda:
        raise ValueError("wq_matmul_fwd: x must be a CUDA tensor")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"wq_matmul_fwd: x must be bfloat16, got {x.dtype}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    y, _x2, args = _launch_args(x, w, scale, fault, stream)
    from visionselector_tpu_torch.kernels import _build

    err = _build.load().vst_wq_matmul_fwd(*args)
    if err:
        raise RuntimeError(f"wq_matmul_fwd launch failed: CUDA error {err}")
    WQ_LAUNCHES += 1
    return y.reshape(*x.shape[:-1], y.shape[-1])


def wq_matmul(x: torch.Tensor, w: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x [.., K] @ the quantized kernel: kernel A for a CUDA tensor (bf16,
    a shape ``wq_plan`` takes; anything else raises), the plain version
    for a CPU tensor. The kernel's output carries no gradient:
    ``lm._dense`` sends products under grad to ``wq_dequant_matmul``."""
    if not x.is_cuda:
        return wq_matmul_plain(x, w, scale)
    return _launch(x, w, scale)


def wq_dequant(w: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``dequantize(w, scale, dtype)``: kernel B for CUDA tensors (bf16 out,
    N a multiple of 8; anything else raises), the plain version on the
    CPU. The result carries no gradient."""
    global WQ_DEQUANT_LAUNCHES
    if not w.is_cuda:
        return dequantize(w, scale, dtype)
    k, n, bits, group = _check(w.shape[0], w.device, w, scale)
    if dtype != torch.bfloat16 or n % 8:
        raise ValueError(f"wq_dequant_fwd: writes a bfloat16 transient of N "
                         f"a multiple of 8, not {dtype} of N = {n}")
    out = torch.empty((k, n), dtype=dtype, device=w.device)
    from visionselector_tpu_torch.kernels import _build

    err = _build.load().vst_wq_dequant_fwd(
        w.data_ptr(), scale.data_ptr(), out.data_ptr(), k, n, bits, group,
        torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        raise RuntimeError(f"wq_dequant_fwd launch failed: CUDA error {err}")
    WQ_DEQUANT_LAUNCHES += 1
    return out


def wq_dequant_matmul(x: torch.Tensor, w: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The route for prefill rows and products under grad: the layer's
    kernel dequantized into a transient (``wq_dequant``), then
    ``torch.matmul`` and, per channel, the scale; counted in
    ``WQ_DEQUANT_CALLS`` on the card. Equal to ``wq_matmul_plain`` bit for
    bit."""
    global WQ_DEQUANT_CALLS
    if x.is_cuda:
        WQ_DEQUANT_CALLS += 1
    y = x @ wq_dequant(w, scale, x.dtype)
    if scale.dim() == 1:
        y = y * scale.to(x.dtype)
    return y


def bytes_moved(rows: int, w: torch.Tensor, scale: torch.Tensor) -> int:
    """The bytes one kernel-A call must move: the stored weight, its
    scales, x and y (bf16), each once. Over 3.35 TB/s this is its bound."""
    n = scale.shape[-1]
    return (w.numel() * w.element_size() + scale.numel() * 4
            + 2 * rows * w.shape[0] + 2 * rows * n)


def dequant_bytes(w: torch.Tensor, scale: torch.Tensor) -> int:
    """The bytes one kernel-B call must move: the stored weight and its
    scales read, the bf16 [K, N] transient written, each once."""
    return (w.numel() * w.element_size() + scale.numel() * 4
            + 2 * w.shape[0] * scale.shape[-1])
