"""The port's W8A8 vision tower (``vit.quantize_vit_params`` /
``_vit_dense``) against the JAX package's on qwen25vl_tiny: the quantized
tree bit for bit, the W8A8 forward, and the reference's own accuracy bar
against the fp32 tower. Inputs are made with numpy from a seed; fp32.

Tolerances: the W8A8 forward atol 1e-4 (fp32 through 4 blocks and the
merger, as tests/test_torch_vit.py; one activation value rounded the
other way moves an output by ~1e-5); against the fp32 tower the
reference's bar, cosine > 0.98 and relative error < 0.2
(tests/test_int8.py). The JAX side quantizes its weights eagerly.

JAX's jit caches are not keyed on ``VST_*`` variables, so the JAX call
made under ``VST_FUSED_ATTN`` runs between ``jax.clear_caches()`` calls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import vit as jvit
from visionselector_tpu.preprocess import indices as jidx
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl import vit as tvit
from visionselector_tpu_torch.models.qwen25vl.weights import (
    from_jax_params,
    pad_vit_head_dim,
)
from visionselector_tpu_torch.preprocess import indices as tidx

FIELDS = ("pixel_values", "rot_pos_ids", "window_seg_ids", "full_seg_ids",
          "reverse_index")


def _configs(inter):
    """The tiny configs, with the ViT's MLP width ``inter`` (124 is not a
    multiple of 8: the stored kernels are padded)."""
    j, t = jax_tiny(), qwen25vl_tiny()
    return (dataclasses.replace(j, vision=dataclasses.replace(
                j.vision, intermediate_size=inter)),
            dataclasses.replace(t, vision=dataclasses.replace(
                t.vision, intermediate_size=inter)))


_TOWERS = {}


def _towers(inter):
    """(JAX float visual tree, JAX W8A8 tree, port float tower, port tower
    quantized by the port, port tower carried from the JAX W8A8 tree,
    configs), made once per MLP width."""
    if inter not in _TOWERS:
        jcfg, tcfg = _configs(inter)
        tree = jax_param_tree(jcfg, seed=3)
        visual = jax.tree.map(jnp.asarray, tree["visual"])
        q8 = jax.tree.map(np.asarray, jvit.quantize_vit_params(visual))
        fp = from_jax_params(tree, tcfg, "cpu").visual
        mine = tvit.quantize_vit_params(
            from_jax_params(tree, tcfg, "cpu").visual)
        carried = from_jax_params(dict(tree, visual=q8), tcfg, "cpu").visual
        _TOWERS[inter] = visual, q8, fp, mine, carried, jcfg, tcfg
    return _TOWERS[inter]


@pytest.fixture(scope="module", params=[128, 124], ids=["i128", "i124"])
def towers(request):
    return _towers(request.param)


@pytest.fixture(scope="module")
def padded_towers():
    """The towers at MLP width 124: the routes below run on the padded
    kernels."""
    return _towers(124)


@pytest.fixture(scope="module")
def batch():
    """The same window-aligned batch from both packages' host prep (the
    kv-tile bounds are built at each package's own block)."""
    jcfg = jax_tiny().vision
    grid = np.asarray([[1, 8, 16]])
    px = np.random.RandomState(7).randn(128, jcfg.patch_dim).astype(
        np.float32)
    kw = dict(window_size=jcfg.window_size, pad_to=256, align_windows=True)
    tb = tidx.build_vision_batch(px, grid, **kw)
    tb.jax = jidx.build_vision_batch(px, grid, **kw)
    return tb


def _bounds(vb, t):
    return dict(window_kv_bounds=t(vb.window_kv_bounds),
                full_kv_bounds=t(vb.full_kv_bounds),
                window_diag=vb.window_diag)


def _port(tower, vb, **kw):
    t = torch.as_tensor
    with torch.no_grad():
        return tvit.vit_forward(tower, *(t(getattr(vb, f)) for f in FIELDS),
                                **_bounds(vb, t), **kw).numpy()


def _jax(tree, vb, cfg):
    return np.asarray(jvit.vit_forward(
        jax.tree.map(jnp.asarray, tree),
        *(jnp.asarray(getattr(vb.jax, f)) for f in FIELDS), cfg.vision,
        **_bounds(vb.jax, jnp.asarray)))


@pytest.mark.parametrize("name", tvit.VIT_QUANT_KERNELS)
def test_quantized_tree_is_bit_equal(towers, name):
    """Every block's int8 values and fp32 scales equal the reference's
    ``quantize_vit_params``; the alignment padding is zeros; the tree
    carried from JAX holds the same buffers."""
    _, q8, _, mine, carried, _, _ = towers
    for i, (blk, blk_c) in enumerate(zip(mine.blocks, carried.blocks)):
        q = tvit.vit_quantized_kernel(blk, name)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), q8["blocks"][name][i])
        np.testing.assert_array_equal(
            getattr(blk, name + "_scale").numpy(),
            q8["blocks"][name + "_scale"][i])
        stored = getattr(blk, name)
        assert stored.shape[0] % 8 == 0 and stored.shape[1] % 8 == 0
        assert int(stored.abs().sum()) == int(q.abs().sum())  # pads zero
        assert torch.equal(stored, getattr(blk_c, name))
        assert torch.equal(getattr(blk, name + "_scale"),
                           getattr(blk_c, name + "_scale"))


def test_w8a8_forward_matches_jax(towers, batch):
    """The port's W8A8 ``vit_forward`` (default route: diag windows, flash
    full layers with bounds) against JAX's W8A8 forward within 1e-4, and
    the reference's bar against the fp32 tower."""
    visual, q8, fp, mine, carried, jcfg, _ = towers
    n = batch.num_merged
    want = _jax(q8, batch, jcfg)[:n]
    got = _port(mine, batch)[:n]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(_port(carried, batch)[:n], got)
    ref = _port(fp, batch)[:n]
    cos = (ref * got).sum() / (np.linalg.norm(ref) * np.linalg.norm(got))
    rel = np.linalg.norm(ref - got) / np.linalg.norm(ref)
    assert cos > 0.98 and rel < 0.2, (cos, rel)
    assert rel > 0  # the products did go through int8


def test_int8_matmul_padding_is_exact():
    """The padded product (activation columns and kernel rows and columns
    padded with zeros) equals the plain unpadded int8 product bit for bit,
    at the 3B MLP's widths cut down (K 3,420 -> 124)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (40, 124), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (124, 60), generator=g, dtype=torch.int8)
    wp = torch.nn.functional.pad(w, (0, 4, 0, 4))
    got = tvit.int8_matmul(a, wp)
    assert got.dtype == torch.int32 and got.shape == (40, 64)
    assert torch.equal(got[:, :60], tvit.int8_matmul_plain(a, w))
    assert not got[:, 60:].any()


def test_w8a8_stats_forward_matches_jax(padded_towers, batch):
    """``vit_forward_stats`` (the strategies' ViT) on a W8A8 tower: its
    last block's products go through ``_vit_dense`` too. atol 5e-4: the
    two packages compute the last block's attention on different paths
    (fp32 sums in another order), and an activation that lands on the
    other side of an int8 rounding boundary moves its product by one int8
    step (~2.5e-4 here), where the fp32 tower's outputs move by ~1e-7."""
    _, q8, _, mine, _, jcfg, _ = padded_towers
    n = batch.num_merged
    want = jvit.vit_forward_stats(
        jax.tree.map(jnp.asarray, q8),
        *(jnp.asarray(getattr(batch.jax, f)) for f in FIELDS), jcfg.vision,
        **_bounds(batch.jax, jnp.asarray))
    t = torch.as_tensor
    with torch.no_grad():
        got = tvit.vit_forward_stats(
            mine, *(t(getattr(batch, f)) for f in FIELDS),
            **_bounds(batch, t))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy()[:n], np.asarray(w_)[:n],
                                   atol=5e-4, rtol=0)


def test_packed_w8a8_equals_default(padded_towers, batch):
    """Heads zero-padded to 128 (the "packed" layout) on a W8A8 tower: the
    int8 qkv / proj kernels are padded too and the function is the same."""
    _, _, _, mine, _, _, tcfg = padded_towers
    padded = pad_vit_head_dim(mine, tcfg.vision, dp=32)
    assert tvit.head_width(padded) == 32 and tvit.is_vit_quantized(padded)
    n = batch.num_merged
    np.testing.assert_allclose(_port(padded, batch)[:n],
                               _port(mine, batch)[:n], atol=1e-5, rtol=0)


def test_fused_route_keeps_w8a8_and_the_reference_does_not(
        padded_towers, batch, monkeypatch):
    """The reference's fused branch (``vit.py:173-181``) multiplies the
    attention output and the MLP by the raw int8 proj / gate / up / down
    kernels with no scale: its fused W8A8 forward is far from its own
    default W8A8 forward, which the port's matches (relative distance
    1.41 on this input, against < 0.2 from the fp32 tower; ROADMAP
    section 3, quirk). The port keeps the W8A8 products under "fused":
    equal to its default route."""
    _, q8, _, mine, _, jcfg, _ = padded_towers
    n = batch.num_merged
    default = _port(mine, batch)[:n]
    fused = _port(mine, batch, attn_variant="fused")[:n]
    np.testing.assert_allclose(fused, default, atol=1e-5, rtol=0)
    jax.clear_caches()
    monkeypatch.setenv("VST_FUSED_ATTN", "1")
    try:
        quirk = _jax(q8, batch, jcfg)[:n]
    finally:
        monkeypatch.delenv("VST_FUSED_ATTN")
        jax.clear_caches()
    rel = np.linalg.norm(quirk - default) / np.linalg.norm(default)
    assert rel > 0.5, rel


def test_quantize_twice_raises(padded_towers):
    with pytest.raises(ValueError, match="already W8A8"):
        tvit.quantize_vit_params(padded_towers[3])
