"""The weight-only GEMM's launch plan (``kernels.wq_matmul.wq_plan``) at
the decoder shapes of Qwen2.5-VL 3B and 7B and LLaVA-OneVision-1.5-8B,
for int8, int4 and int4:g128 at every row count the kernel takes (1-64):

- every product launches at least one block per SM (132), and two (264)
  wherever K, the group size and a cluster's 16 blocks allow it (the
  narrowest column tile, 16 columns, times the whole units of K, at most
  16: 64 rows a unit per channel, a group else);
- the K splits cover K exactly once, in whole units (whole groups under
  groups), at most 16 a column tile (one cluster);
- the wrapper hands the kernel the plan and needs no workspace: the
  splits meet in distributed shared memory (``_launch_args`` on CPU
  tensors: no card, no build);
- the row caps stay within the kernel's 64 rows, bad shapes raise, and a
  block's shared memory fits the H100's 227 KB.

Pure Python, milliseconds: no model is built, no kernel runs."""

import pytest
import torch

from visionselector_tpu_torch.core.config import (
    llava_ov15_8b,
    qwen25vl_3b,
    qwen25vl_7b,
)
from visionselector_tpu_torch.kernels import wq_matmul as wq
from visionselector_tpu_torch.models.qwen25vl.lm import pack_int4

SPECS = {"int8": (8, 0), "int4": (4, 0), "int4:g128": (4, 128)}
MODELS = {"3b": qwen25vl_3b, "7b": qwen25vl_7b, "ov8b": llava_ov15_8b}
SMEM_LIMIT = 232448  # bytes of shared memory an H100 block can use


def _shapes(model):
    """(K, N) of a decoder layer's seven products."""
    t = MODELS[model]().text
    d, i = t.hidden_size, t.intermediate_size
    hq = t.num_attention_heads * t.head_dim
    hkv = t.num_key_value_heads * t.head_dim
    return sorted({(d, hq), (d, hkv), (hq, d), (d, i), (i, d)})


def _all_shapes():
    return sorted({kn for m in MODELS for kn in _shapes(m)})


def _most_blocks(k, n, group):
    """The most blocks any plan could launch: 16-column tiles times the
    whole units of K, at most a cluster's 16."""
    unit = group or wq.WQ_SPLIT_ROWS
    return -(-n // (8 * min(wq.WQ_LANE_COLS))) * min(-(-k // unit),
                                                      wq.WQ_MAX_SPLITS)


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("model", list(MODELS))
def test_plan_fills_the_card(model, spec):
    bits, group = SPECS[spec]
    for k, n in _shapes(model):
        for rows in range(1, wq.WQ_KERNEL_ROWS + 1):
            p = wq.wq_plan(rows, k, n, bits, group)
            assert p.blocks == p.tiles * p.splits
            assert p.blocks >= wq.WQ_SMS, (k, n, rows, p)
            if _most_blocks(k, n, group) >= wq.WQ_TARGET_BLOCKS:
                assert p.blocks >= wq.WQ_TARGET_BLOCKS, (k, n, rows, p)
            assert p.tiles == -(-n // p.col_tile)
            assert p.col_tile == 8 * p.cols_per_thread
            assert rows <= p.row_tile in wq.WQ_ROW_TILES
            assert p.stages == wq.WQ_STAGES >= 3


@pytest.mark.parametrize("spec", list(SPECS))
def test_splits_cover_k_once_in_whole_units(spec):
    bits, group = SPECS[spec]
    unit = group or wq.WQ_SPLIT_ROWS
    for k, n in _all_shapes():
        for rows in (1, 8, 33, 64):
            p = wq.wq_plan(rows, k, n, bits, group)
            assert p.split_rows % unit == 0
            assert 1 <= p.splits <= wq.WQ_MAX_SPLITS == 16
            bounds = [(s * p.split_rows, min(k, (s + 1) * p.split_rows))
                      for s in range(p.splits)]
            assert all(a < b for a, b in bounds), (k, n, p)
            covered = [r for a, b in bounds for r in range(a, b)]
            assert covered == list(range(k))
            if group:
                assert all(a % group == 0 for a, _ in bounds)


@pytest.mark.parametrize("spec", list(SPECS))
def test_launch_arguments_are_the_plans(spec):
    """``_launch_args`` on CPU tensors: y, x as the kernel reads it (a
    strided view copied to a contiguous one), and the plan's values in the
    C entry's argument list; nothing else is allocated (no workspace: a
    column tile's splits meet in its cluster's shared memory)."""
    bits, group = SPECS[spec]
    gen = torch.Generator().manual_seed(3)
    unit = group or wq.WQ_SPLIT_ROWS  # K of one unit: one split
    for k, n, rows in ((2048, 256, 5), (2048, 256, 64), (unit, 64, 1)):
        q = torch.randint(-7, 8, (k, n), generator=gen, dtype=torch.int8)
        w = pack_int4(q) if bits == 4 else q
        s = torch.rand((k // group, n) if group else (n,), generator=gen)
        x = torch.randn(rows, 2 * k, generator=gen).bfloat16()[:, ::2]
        p = wq.wq_plan(rows, k, n, bits, group)
        y, x2, args = wq._launch_args(x, w, s, fault=4, stream=7)
        assert y.shape == (rows, n) and y.dtype == torch.bfloat16
        assert x2.is_contiguous() and torch.equal(x2, x)
        assert args[:4] == (x2.data_ptr(), w.data_ptr(), s.data_ptr(),
                            y.data_ptr())
        assert args[4:] == (rows, k, n, bits, group, p.cols_per_thread,
                            p.row_tile, p.tiles, p.splits, p.split_rows, 4,
                            7)
    assert wq.wq_plan(5, 2048, 256, bits, group).splits > 1
    assert wq.wq_plan(1, unit, 64, bits, group).splits == 1


def test_row_caps_stay_within_the_kernel():
    assert wq.WQ_KERNEL_ROWS == 64 == max(wq.WQ_ROW_TILES)
    assert set(wq.WQ_MAX_ROWS) == {torch.int8, torch.uint8}
    for cap in wq.WQ_MAX_ROWS.values():
        assert 1 <= cap <= wq.WQ_KERNEL_ROWS


@pytest.mark.parametrize("rows, k, n, bits, group", [
    (0, 2048, 256, 8, 0),      # no rows
    (65, 2048, 256, 8, 0),     # more rows than the kernel's tiles
    (1, 2044, 256, 8, 0),      # K not a multiple of 8
    (1, 2048, 250, 4, 0),      # a packed row of 125 bytes
    (1, 2048, 256, 8, 128),    # groups with int8
    (1, 2048, 256, 4, 24),     # a group not a multiple of 16
    (1, 2064, 256, 4, 32),     # a group that does not divide K
])
def test_bad_shapes_raise(rows, k, n, bits, group):
    assert wq.plan_error(rows, k, n, bits, group)
    with pytest.raises(ValueError):
        wq.wq_plan(rows, k, n, bits, group)


def test_shared_memory_fits_a_block():
    for bits, group in SPECS.values():
        for k, n in _all_shapes():
            for rows in wq.WQ_ROW_TILES:
                assert wq.wq_plan(rows, k, n, bits, group).smem + 64 <= (
                    SMEM_LIMIT)


def test_cpu_products_take_the_plain_route():
    """``use_kernel`` is for CUDA bf16 x only; on the CPU both wrappers are
    the plain versions, bit for bit."""
    gen = torch.Generator().manual_seed(5)
    q = torch.randint(-7, 8, (256, 64), generator=gen, dtype=torch.int8)
    w, s = pack_int4(q), torch.rand(2, 64, generator=gen)
    x = torch.randn(3, 256, generator=gen).bfloat16()
    assert not wq.use_kernel(x, w, s)
    want = wq.wq_matmul_plain(x, w, s)
    assert torch.equal(wq.wq_matmul(x, w, s), want)
    assert torch.equal(wq.wq_dequant_matmul(x, w, s), want)
    assert torch.equal(wq.wq_dequant(w, s, torch.bfloat16),
                       wq.dequantize(w, s, torch.bfloat16))
