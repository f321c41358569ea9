"""The plain versions of K6's rotary prologue (``fused_vit_attn.py``): the
wgmma tile-image layout, the rotated images against ``apply_rotary`` (the
port's, bit for bit; the JAX package's within one bf16 ulp in bf16 and
1e-6 in fp32, since XLA on the CPU may fuse the bf16 products), and the
per-tile segment ids against numpy on the window, full and video layouts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import _tile_seg_np
from test_torch_fused import _layouts

from visionselector_tpu.models.qwen25vl import vit as jvit
from visionselector_tpu_torch.kernels import fused_vit_attn as F_

HEAD_DIMS = [16, 24, 64, 80, 128]


@pytest.mark.parametrize("rows,cols", [(64, 80), (32, 64)])
def test_image_layout_is_the_core_matrix_formula(rows, cols):
    """Element (r, k) sits at ((r//8) * (C//8) + k//8) * 64 + (r%8) * 8 +
    k%8, the layout hopper_common.cuh describes."""
    x = torch.arange(rows * cols, dtype=torch.int32).view(rows, cols)
    img = F_._to_image(x).numpy()
    r, k = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    off = ((r // 8) * (cols // 8) + k // 8) * 64 + (r % 8) * 8 + k % 8
    np.testing.assert_array_equal(img[off], x.numpy())
    assert torch.equal(F_._from_image(F_._to_image(x), rows, cols), x)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_pack_tiles_round_trips_and_zero_fills(d, transpose):
    s, h = 133, 3
    x = torch.from_numpy(np.random.RandomState(d).randn(s, h, d)
                         .astype(np.float32)) + 1.0
    img = F_.pack_tiles(x, transpose=transpose)
    nt, dp = 3, F_.padded_head_dim(d)
    assert img.shape == (h, nt, 64 * dp)
    assert torch.equal(F_.unpack_tiles(img, s, d, transpose=transpose), x)
    r, c = (dp, 64) if transpose else (64, dp)
    full = F_._from_image(img, r, c)
    if transpose:
        full = full.transpose(-1, -2)
    full = full.reshape(h, nt * 64, dp)
    assert (full[:, s:] == 0).all() and (full[:, :, d:] == 0).all()
    assert (full[:, :s, :d] != 0).all()


def _slab(d, h=3, s=133, seed=0):
    rng = np.random.RandomState(seed + d)
    qkv = rng.randn(s, 3 * h * d).astype(np.float32)
    cos, sin = jvit.vision_rotary_cos_sin(
        jnp.asarray(rng.randint(0, 30, (s, 2))), d)
    return qkv, np.asarray(cos), np.asarray(sin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_prologue_plain_is_apply_rotary(d, dtype):
    h = 3
    qkv, cos, sin = _slab(d, h)
    qkv = torch.from_numpy(qkv).to(dtype)
    cos, sin = torch.from_numpy(cos), torch.from_numpy(sin)
    q_img, k_img, vt_img = F_.prologue_plain(qkv, cos, sin, h, d)
    s = qkv.shape[0]
    q, k, v = qkv.view(s, 3, h, d).unbind(1)
    q, k = F_.apply_rotary(q, k, cos, sin)
    assert torch.equal(F_.unpack_tiles(q_img, s, d), q)
    assert torch.equal(F_.unpack_tiles(k_img, s, d), k)
    assert torch.equal(F_.unpack_tiles(vt_img, s, d, transpose=True), v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_prologue_plain_matches_jax_apply_rotary(d, dtype):
    h = 3
    qkv, cos, sin = _slab(d, h, seed=7)
    s = qkv.shape[0]
    tq = torch.from_numpy(qkv).to(getattr(torch, dtype))
    q_img, k_img, _ = F_.prologue_plain(
        tq, torch.from_numpy(cos), torch.from_numpy(sin), h, d)
    got = [F_.unpack_tiles(x, s, d).float().numpy() for x in (q_img, k_img)]
    jq = jnp.asarray(qkv).astype(dtype).reshape(s, 3, h, d)
    want = [np.asarray(x.astype(jnp.float32)) for x in jvit.apply_rotary(
        jq[:, 0], jq[:, 1], jnp.asarray(cos), jnp.asarray(sin))]
    for g, w in zip(got, want):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        else:  # one bf16 ulp of the larger magnitude: 2^(e - 7)
            mag = np.maximum(np.abs(g), np.abs(w))
            ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
            assert (np.abs(g - w) <= ulp).all()


@pytest.mark.parametrize("s", [256, 333])
@pytest.mark.parametrize("kind", ["window", "full", "video"])
def test_tile_seg_plain_matches_numpy(kind, s):
    seg = _layouts(s)[kind]
    got = F_.tile_seg_plain(torch.from_numpy(seg))
    assert got.dtype == torch.int32
    want = _tile_seg_np(seg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).any()
    if kind == "full":  # two images: their inner tiles are uniform
        assert (want > 0).any()
