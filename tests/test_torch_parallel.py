"""The port's parallel paths (``core/mesh.py``, ``lm.shard_lm`` /
``mesh.tensor_parallel``, ``lm.moe_mlp_ep``, ``vit.vit_forward_sp``)
against the JAX package on the CPU.

The port's side runs in ONE gloo world of 4 spawned ranks
(``torch_parallel_ranks``, which imports no jax; a ``file://``
rendezvous under tmp_path), meshed (2, 2) for the 2-way cases and (1, 4)
for the 4-way ones; it runs every case once and each test below asserts
its own entry. The JAX side runs here, on the 8 virtual CPU devices
conftest gives it. Same numpy inputs from a seed; fp32.

Tolerances (the reference's own tests): TP prefill first token equal,
logits atol 2e-4 / rtol 1e-3 (tests/test_tp_inference.py); the MoE
decoder's prefill atol 2e-5 / rtol 1e-4; ``moe_mlp_ep`` atol 2e-5 /
rtol 1e-4; ``vit_forward_sp`` atol 2e-5 (tests/test_vit_sp.py). Every
rank of a case must return the same output bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from torch_parallel_ranks import as_numpy, start_world
from torch_port_params import jax_ov_param_tree, jax_param_tree

from visionselector_tpu.core import mesh as jmesh
from visionselector_tpu.core.config import llava_ov_moe_tiny as jax_moe
from visionselector_tpu.core.config import llava_ov_tiny as jax_ov
from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.models.qwen25vl import vit as jvit
from visionselector_tpu.preprocess.image import preprocess_image
from visionselector_tpu.preprocess.indices import (
    aligned_window_len,
    build_vision_batch,
)
from visionselector_tpu.preprocess.rope import expand_vision_tokens
from visionselector_tpu_torch.core import mesh as tmesh
from visionselector_tpu_torch.core.config import llava_ov_moe_tiny
from visionselector_tpu_torch.core.config import llava_ov_tiny
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.llava_ov15.weights import (
    ov_from_jax_params,
)
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl import vit as tvit
from visionselector_tpu_torch.models.qwen25vl.weights import (
    from_jax_params,
    lm_from_jax,
)

SP_GRIDS = {"one_image": np.array([[1, 8, 16]]),
            "two_images": np.array([[1, 8, 8], [1, 12, 8]])}
SP_SHARDS = 4


def _aligned(grid, n_shards):
    """tests/test_vit_sp.py's batch: window-aligned, padded to a multiple
    of n_shards window slots."""
    v = jax_tiny().vision
    n = int((grid[:, 0] * grid[:, 1] * grid[:, 2]).sum())
    px = np.random.RandomState(0).randn(n, v.patch_dim).astype(np.float32)
    kw = dict(window_size=v.window_size,
              spatial_merge_size=v.spatial_merge_size,
              patch_size=v.patch_size)
    slot = (v.window_size // v.spatial_merge_size // v.patch_size) ** 2 \
        * v.spatial_merge_unit
    unit = n_shards * slot
    pad = -(-aligned_window_len(grid, **kw) // unit) * unit
    return build_vision_batch(px, grid, pad_to=pad, align_windows=True, **kw)


SP_FIELDS = ("pixel_values", "rot_pos_ids", "window_seg_ids",
             "full_seg_ids", "reverse_index")


def _request():
    rng = np.random.RandomState(5)
    img = (rng.rand(112, 112, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens([100, 200, 300], [400, 500, 600], grid)
    return ids, px, grid


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    qtree = as_numpy(jax_param_tree(jax_tiny(), seed=0, scorer_std=0.02))
    moe_tree = as_numpy(jax_ov_param_tree(jax_moe(), seed=1))
    d = jax_moe().text.hidden_size
    rng = np.random.RandomState(2)
    t = 8
    moe_x = (rng.randn(1, t, d).astype(np.float32),
             np.broadcast_to(np.arange(t), (3, 1, t)).astype(np.int64).copy(),
             np.ones((1, t), np.int32))
    batches = {k: _aligned(g, SP_SHARDS) for k, g in SP_GRIDS.items()}
    inputs = dict(
        qwen_tree=qtree, moe_lm_tree=moe_tree["lm"], request=_request(),
        moe_x=moe_x, ep_x=rng.randn(1, t, d).astype(np.float32),
        sp_batches=[tuple(getattr(b, f) for f in SP_FIELDS)
                    for b in batches.values()])
    results = start_world(4, str(tmp_path_factory.mktemp("world")), inputs)
    return dict(inputs=inputs, results=results, moe_tree=moe_tree,
                batches=batches)


def _case(world, name):
    """Rank 0's output of a case, after checking every rank gave the same
    (or reporting a rank's traceback)."""
    outs = []
    for rank, res in enumerate(world["results"]):
        assert "error" not in res, res["error"]
        out = res[name]
        assert not (isinstance(out, dict) and "error" in out), (
            f"rank {rank}: {out.get('error')}")
        outs.append(out)
    for rank, out in enumerate(outs[1:], 1):
        _assert_same(out, outs[0], f"{name} rank {rank}")
    return outs[0]


def _assert_same(a, b, what):
    if isinstance(a, dict):
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=what)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)


@pytest.fixture(scope="module")
def single(world):
    """The JAX first-token logits and the port's single-device tokens of
    the TP request."""
    qtree = world["inputs"]["qwen_tree"]
    ids, px, grid = world["inputs"]["request"]
    jeng = jmodel.QwenVLEngine(jax_tiny(), jax.tree.map(jnp.asarray, qtree),
                               use_selector=True, budget=0.5)
    p = jeng._prep_vision(ids, px, grid, grid, None, None)
    vb = p.vb
    out = jmodel._prefill(
        jeng.params, jeng.cfg, p.k_max, jeng.use_selector,
        *(jnp.asarray(getattr(vb, f)) for f in SP_FIELDS),
        jnp.asarray(p.n), jnp.asarray(p.k), jnp.asarray(ids),
        jnp.asarray(p.image_pos_padded), jnp.asarray(p.text_pos_padded),
        jnp.asarray(p.num_text), jnp.asarray(p.position_ids),
        jnp.asarray(vb.window_kv_bounds), jnp.asarray(vb.full_kv_bounds),
        window_diag=vb.window_diag, window_kv_iters=vb.window_kv_iters,
        full_kv_iters=vb.full_kv_iters)
    teng = tmodel.QwenVLEngine(qwen25vl_tiny(),
                               from_jax_params(qtree, qwen25vl_tiny(), "cpu"),
                               use_selector=True, budget=0.5, device="cpu")
    res = teng.generate(ids, px, grid, max_new_tokens=4)
    return dict(token=int(out[0]), logits=np.asarray(out[6]),
                tokens=res.tokens, selected=res.selected_indices)


@pytest.mark.parametrize("tp, heads", [("tp2", (2, 1)), ("tp4", (1, 1))])
def test_tp_generate_matches_single_device(world, single, tp, heads):
    """Tensor-parallel prefill at tp 2 (2 of 4 query heads, 1 of 2 kv heads
    a rank) and tp 4 (one query head a rank; the 2 kv heads replicated over
    2 ranks each): the first token equal to JAX's single-device
    ``_prefill``, its logits within atol 2e-4 / rtol 1e-3, the kept set and
    the greedy tokens equal to the port's single-device engine."""
    got = _case(world, "case_tp_generate")[tp]
    assert tuple(got["heads"]) == heads
    assert got["tokens"][0] == single["token"]
    np.testing.assert_allclose(got["logits"], single["logits"], atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_array_equal(got["selected"], single["selected"])
    assert got["tokens"] == single["tokens"]


@pytest.mark.parametrize("tp", ["tp2", "tp4"])
def test_tp_sampled_tokens_agree_across_ranks(world, tp):
    """A sampled request (temperature 1.5, top_p 0.95) draws the same
    tokens on every rank with no broadcast: the gathered logits and the
    seeded generators are the same on each (``_case`` holds every rank's
    output equal bit for bit)."""
    got = _case(world, "case_tp_generate")[tp]
    assert len(got["sampled"]) == 4


def test_tp_moe_prefill_matches_jax(world):
    """The MoE decoder sharded inside each expert (intermediate 64 -> 32 a
    rank, all 4 experts on every rank) against JAX's single-device
    ``lm_prefill`` within 2e-5."""
    got = _case(world, "case_tp_moe_prefill")
    assert tuple(got["mi"]) == (4, 96, 32)
    embeds, pos, seg = world["inputs"]["moe_x"]
    want, _ = jlm.lm_prefill(
        jax.tree.map(jnp.asarray, world["moe_tree"]["lm"]),
        jnp.asarray(embeds), jnp.asarray(pos), jnp.asarray(seg),
        jax_moe().text)
    np.testing.assert_allclose(got["hidden"], np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_moe_ep_matches_jax_and_single_device(world):
    """``moe_mlp_ep`` over 2 ranks against JAX's ``moe_mlp_ep`` on a
    (4, 2) mesh and the port's single-device routed ``_moe_mlp``."""
    got = _case(world, "case_moe_ep")
    layer0 = jax.tree.map(lambda a: jnp.asarray(a[0]),
                          world["moe_tree"]["lm"]["layers"])
    x = world["inputs"]["ep_x"]
    want = jlm.moe_mlp_ep(jnp.asarray(x), layer0, jax_moe().text,
                          jmesh.make_mesh(n_data=4, n_model=2))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-4)
    lm = lm_from_jax(world["moe_tree"]["lm"], llava_ov_moe_tiny().text,
                         "cpu", torch.float32)
    with torch.no_grad():
        dense = tlm._moe_mlp(torch.from_numpy(x), lm.layers[0],
                             llava_ov_moe_tiny().text).numpy()
    np.testing.assert_allclose(got, dense, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("grid", sorted(SP_GRIDS))
def test_vit_sp_matches_jax(world, grid):
    """``vit_forward_sp`` over 4 shards (the two-image grid's full-attention
    segments straddle shards) against JAX's single-device ``vit_forward``
    within 2e-5."""
    i = list(SP_GRIDS).index(grid)
    got = _case(world, "case_vit_sp")[i]
    vb = world["batches"][grid]
    want = jvit.vit_forward(
        jax.tree.map(jnp.asarray, world["inputs"]["qwen_tree"]["visual"]),
        *(jnp.asarray(getattr(vb, f)) for f in SP_FIELDS), jax_tiny().vision)
    n = vb.num_merged
    np.testing.assert_allclose(got[:n], np.asarray(want)[:n], atol=2e-5)


def _port_params(family):
    if family == "qwen25vl":
        tree = jax_param_tree(jax_tiny(), seed=0)
        return tree, from_jax_params(tree, qwen25vl_tiny(), "cpu")
    jcfg, tcfg = ((jax_ov(), llava_ov_tiny()) if family == "ov"
                  else (jax_moe(), llava_ov_moe_tiny()))
    tree = jax_ov_param_tree(jcfg, seed=0)
    return tree, ov_from_jax_params(tree, tcfg, "cpu")


def _jax_leaf(tree, name):
    """The reference leaf of a port parameter name (layer indices dropped:
    the reference stacks layers on a leading axis)."""
    node = tree
    for part in name.split("."):
        if not part.isdigit():
            node = node[part]
    return node


@pytest.mark.parametrize("family", ["qwen25vl", "ov", "moe"])
def test_sharding_rules_match_jax(family):
    """``param_sharding_rules`` gives every leaf of the port's tree the
    axis (counted from the end) JAX's rules give the same leaf: the
    3B-tiny, OV-tiny and MoE-tiny trees (the MoE expert kernels their
    intermediate axis)."""
    tree, params = _port_params(family)
    named = dict(params.named_parameters()) | dict(params.named_buffers())
    seen = 0
    for name, t in named.items():
        leaf = _jax_leaf(tree, name)
        path = tuple(jax.tree_util.DictKey(k) for k in name.split(".")
                     if not k.isdigit())
        spec = jmesh.param_sharding_rules(
            tuple(p.key for p in path), leaf)
        want = [i - leaf.ndim for i, s in enumerate(spec) if s == "model"]
        ax = tmesh.param_sharding_rules(name, t.dim())
        assert ([] if ax is None else [ax - t.dim()]) == want, name
        seen += ax is not None
    assert seen > 0
    if family == "moe":
        gate = named["lm.layers.0.expert_gate_kernel"]
        assert tmesh.param_sharding_rules(
            "lm.layers.0.expert_gate_kernel", gate.dim()) == 2


@pytest.mark.parametrize("index", [0, 1])
def test_shard_params_matches_jax_shards(index):
    """``shard_params`` on a 2-way "model" axis: each leaf's local tensor
    equals the shard JAX's ``shard_params`` puts on the device at that
    model index (the vocabulary 151,936 divides; the tiny scorer and norms
    replicate), except the ViT qkv slab, which the port splits by heads."""
    tree, params = _port_params("qwen25vl")
    mesh = tmesh.Mesh({"data": 1, "model": 2}, index, torch.device("cpu"),
                      "gloo", {})
    local = tmesh.shard_params(params, mesh,
                               qkv_heads=qwen25vl_tiny().vision.num_heads)
    jm = jmesh.make_mesh(n_data=4, n_model=2)
    sharded = jmesh.shard_params(jax.tree.map(jnp.asarray, tree), jm)
    dev = jm.devices[0, index]
    for name, t in local.items():
        jleaf = _jax_leaf(sharded, name)
        shard = next(np.asarray(s.data) for s in jleaf.addressable_shards
                     if s.device == dev)
        layer = [int(p) for p in name.split(".") if p.isdigit()]
        if layer:
            shard = shard[layer[0]]
        if "qkv_kernel" in name:
            full = np.asarray(_jax_leaf(tree, name))[layer[0]]
            h = qwen25vl_tiny().vision.num_heads
            shard = full.reshape(full.shape[0], 3, 2, h // 2, -1)[
                :, :, index].reshape(full.shape[0], -1)
        np.testing.assert_array_equal(t.numpy(), shard, err_msg=name)


def test_batch_sharding_matches_jax():
    """A rank's part of a batch under ``batch_sharding`` (axis 0), equal
    to JAX's shard on the device at that data index."""
    jm = jmesh.make_mesh(n_data=4, n_model=2)
    x = np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)
    for rank in range(8):
        mesh = tmesh.Mesh({"data": 4, "model": 2}, rank, torch.device("cpu"),
                          "gloo", {})
        dev = jm.devices[rank // 2, rank % 2]
        sharding = jmesh.batch_sharding(jm)(x)
        assert isinstance(sharding, NamedSharding)
        placed = jax.device_put(x, sharding)
        want = next(np.asarray(s.data) for s in placed.addressable_shards
                    if s.device == dev)
        got = tmesh.batch_sharding(mesh)(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)


def _stub_mesh(n, index=0):
    return tmesh.Mesh({"data": 1, "model": n}, index, torch.device("cpu"),
                      "gloo", {"model": None})


@pytest.mark.parametrize("family, index", [("qwen25vl", 0), ("qwen25vl", 1),
                                           ("moe", 1)])
def test_shard_lm_follows_the_sharding_rules(family, index):
    """``lm.shard_lm`` over 2 ranks keeps, of every decoder leaf, the slice
    ``shard_params`` (``param_sharding_rules``, held to JAX's above) gives
    it, the MoE expert kernels included; a q / k / v bias, which the
    rules replicate, goes with its kernel's columns. At 2 ranks the tiny
    decoders' 2 kv heads split, so kv-head replication does not arise."""
    lm = _port_params(family)[1].lm
    want = tmesh.shard_params(lm, _stub_mesh(2, index))
    tlm.shard_lm(lm, _stub_mesh(2, index))
    got = dict(lm.named_parameters()) | dict(lm.named_buffers())
    assert got.keys() == want.keys()
    for name, t in got.items():
        w = want[name]
        if name.endswith("_bias") and t.shape != w.shape:
            w = tmesh.local_slice(w, -1, index, 2)
        torch.testing.assert_close(t, w, rtol=0, atol=0, msg=name)


def test_ep_uneven_experts_raise():
    """4 experts over 3 ranks: ValueError (the reference asserts)."""
    lm = tlm.init_lm_params(llava_ov_moe_tiny().text,
                            torch.Generator().manual_seed(0), "cpu",
                            torch.float32)
    x = torch.zeros(1, 2, llava_ov_moe_tiny().text.hidden_size)
    with pytest.raises(ValueError, match="4 experts do not split over 3"):
        tlm.moe_mlp_ep(x, lm.layers[0], llava_ov_moe_tiny().text,
                       _stub_mesh(3))


def test_sp_unaligned_patches_raise(world):
    """A batch padded for 4 shards split over 3: ValueError."""
    vb = world["batches"]["one_image"]
    tower = from_jax_params(world["inputs"]["qwen_tree"], qwen25vl_tiny(),
                            "cpu").visual
    with pytest.raises(ValueError, match="whole 16-patch window slots"):
        tvit.vit_forward_sp(tower, *(torch.from_numpy(getattr(vb, f))
                                     for f in SP_FIELDS), _stub_mesh(3))


def test_grouped_int4_row_slice_that_does_not_divide_raises():
    """int4 with groups of 32 over 2 ranks: the o kernel's rows split at
    48 (2 heads of 24), not a whole group: ValueError before anything
    changes. Groups of 16 divide."""
    def lm(spec):
        m = tlm.init_lm_params(qwen25vl_tiny().text,
                               torch.Generator().manual_seed(0), "cpu",
                               torch.float32)
        return tlm.quantize_lm_params(m, 4, int(spec))

    bad = lm(32)
    before = bad.layers[0].o_kernel.clone()
    with pytest.raises(ValueError, match="whole groups of 32"):
        tlm.shard_lm(bad, _stub_mesh(2))
    assert torch.equal(bad.layers[0].o_kernel, before)
    assert bad.cfg.num_attention_heads == 4
    ok = tlm.shard_lm(lm(16), _stub_mesh(2, 1))
    assert ok.layers[0].o_kernel_scale.shape == (48 // 16, 96)
    assert ok.layers[0].q_kernel.shape == (96, 24)  # 48 columns, packed


def test_tp_text_config():
    """Rank-local configs: 16 / 2 heads over 2 and 4 ranks (the 3B), 28 /
    4 over 2 (the 7B); a split that does not divide raises."""
    cfg = dataclasses.replace(qwen25vl_tiny().text, num_attention_heads=16,
                              num_key_value_heads=2, hidden_size=2048,
                              intermediate_size=11008)
    two, four = tlm.tp_text_config(cfg, 2), tlm.tp_text_config(cfg, 4)
    assert (two.num_attention_heads, two.num_key_value_heads,
            two.intermediate_size, two.head_dim) == (8, 1, 5504, 128)
    assert (four.num_attention_heads, four.num_key_value_heads) == (4, 1)
    seven = dataclasses.replace(cfg, num_attention_heads=28,
                                num_key_value_heads=4, hidden_size=3584,
                                intermediate_size=18944)
    assert (tlm.tp_text_config(seven, 2).num_attention_heads,
            tlm.tp_text_config(seven, 2).num_key_value_heads) == (14, 2)
    with pytest.raises(ValueError, match="does not split"):
        tlm.tp_text_config(cfg, 3)
