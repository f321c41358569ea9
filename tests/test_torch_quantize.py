"""The port's weight-only LM quantization (``lm.quantize_lm_params``,
``apply_weight_quantization``, ``init_lm_params_int8``, the quantized
``_dense`` and ``kernels.wq_matmul``'s plain routes, quantized trees in
``from_jax_params`` / ``ov_from_jax_params``, LoRA over a quantized base)
against the JAX package on the 4-layer tiny configs of both families, in
fp32, with the same numpy weights given to both.

Tolerances: integers and scales bit for bit (the JAX side runs eagerly, as
the reference's CLIs call it: under ``jax.jit`` XLA multiplies by 1 / qmax
and its scales move by one ulp); products 1e-5 of their largest |value|
(fp32, another summation order); LoRA forwards 1e-4 (fp32 through four
decoder layers). The grouped spec is ``int4:g24`` (hidden / 4) for
Qwen2.5-VL and ``int4:g32`` for LLaVA-OneVision-1.5, whose o kernel's input
width (4 heads x 32 = 128) 24 does not divide."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ov_params import ov_tree
from torch_serving_params import four_layers, serving_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu.train import lora as jlora
from visionselector_tpu_torch.core.config import llava_ov_tiny, qwen25vl_tiny
from visionselector_tpu_torch.kernels import wq_matmul as wq
from visionselector_tpu_torch.models.llava_ov15.weights import (
    ov_from_jax_params,
)
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.train import lora as tlora

GROUP = {"qwen25vl": 24, "llava_ov15": 32}
FAMILIES = ("qwen25vl", "llava_ov15")


def _specs(family):
    return ["int8", "int4", f"int4:g{GROUP[family]}"]


CASES = [(f, s) for f in FAMILIES for s in _specs(f)]


@pytest.fixture(scope="module")
def trees():
    """family -> (numpy tree, port config) at 4 decoder layers."""
    return {"qwen25vl": (serving_tree(four_layers(jax_tiny()), seed=2),
                         four_layers(qwen25vl_tiny())),
            "llava_ov15": (ov_tree(layers=4, seed=2),
                           four_layers(llava_ov_tiny()))}


def _port(family, tree, cfg):
    load = from_jax_params if family == "qwen25vl" else ov_from_jax_params
    return load(tree, cfg, "cpu")


_JAX_QUANTIZED = {}


def _jax_quantized(trees, family, spec):
    """The reference's ``apply_weight_quantization`` of ``trees[family]``,
    eagerly, with numpy leaves (read-only); made once per (family, spec)."""
    if (family, spec) not in _JAX_QUANTIZED:
        q = jlm.apply_weight_quantization(
            jax.tree.map(jnp.asarray, trees[family][0]), spec)
        _JAX_QUANTIZED[family, spec] = jax.tree.map(np.asarray, q)
    return _JAX_QUANTIZED[family, spec]


@pytest.mark.parametrize("family, spec", CASES)
def test_quantize_matches_eager_jax(trees, family, spec):
    """Integers and scales of every layer's seven kernels bit for bit,
    values whose w / s lies within 1e-6 of a half-integer included: they
    are counted (the seeded weights have a few), not excused."""
    tree, cfg = trees[family]
    want = _jax_quantized(trees, family, spec)["lm"]["layers"]
    params = tlm.apply_weight_quantization(_port(family, tree, cfg), spec)
    near = off = 0
    for i, layer in enumerate(params.lm.layers):
        for name in tlm.QUANT_KERNELS:
            s = getattr(layer, name + "_scale")
            q = wq.weight_ints(getattr(layer, name))
            np.testing.assert_array_equal(s.numpy(), want[name + "_scale"][i])
            off += int((q.numpy() != want[name][i].astype(np.int8)).sum())
            w = np.asarray(tree["lm"]["layers"][name][i], np.float32)
            sg = s.numpy()
            if sg.ndim == 2:
                sg = np.repeat(sg, w.shape[0] // sg.shape[0], axis=0)
            r = w / sg
            near += int((np.abs(np.abs(r - np.trunc(r)) - 0.5) < 1e-6).sum())
    assert off == 0, f"{off} integers differ ({near} near a half-integer)"
    assert q.abs().max() == (127 if spec == "int8" else 7)


@pytest.mark.parametrize("spec", ["int8:g128", "int3", "int4:g"])
def test_bad_specs_raise_the_reference_message(trees, spec):
    tree, cfg = trees["qwen25vl"]
    with pytest.raises(ValueError) as want:
        jlm.apply_weight_quantization(tree, spec)
    params = _port("qwen25vl", tree, cfg)
    with pytest.raises(ValueError) as got:
        tlm.apply_weight_quantization(params, spec)
    assert str(got.value) == str(want.value)
    assert not tlm.is_quantized(params.lm)


def test_spec_parsing_and_a_group_that_does_not_divide(trees):
    """Good specs parse; a group size that does not divide an input width
    raises ValueError before any kernel changes (the reference asserts)."""
    for spec, want in [(None, None), ("", None), ("none", None),
                       ("int8", (8, 0)), ("int4", (4, 0)),
                       ("int4:g128", (4, 128))]:
        assert tlm.parse_quantize_spec(spec) == want
    tree, cfg = trees["qwen25vl"]
    params = _port("qwen25vl", tree, cfg)
    assert tlm.apply_weight_quantization(params, "none") is params
    with pytest.raises(AssertionError):
        jlm.apply_weight_quantization(tree, "int4:g7")
    with pytest.raises(ValueError, match="does not divide"):
        tlm.apply_weight_quantization(params, "int4:g7")
    assert not tlm.is_quantized(params.lm)


@pytest.mark.parametrize("spec", _specs("qwen25vl"))
def test_dense_routes_match_jax(trees, spec):
    """``_dense`` of each quantized kernel (the CPU route) and the
    dequantize route against the reference's ``_dense`` on the same
    integers and scales."""
    tree, cfg = trees["qwen25vl"]
    jq = _jax_quantized(trees, "qwen25vl", spec)["lm"]["layers"]
    params = tlm.apply_weight_quantization(_port("qwen25vl", tree, cfg), spec)
    layer = params.lm.layers[1]
    jlayer = {k: jnp.asarray(v[1]) for k, v in jq.items()}
    rng = np.random.RandomState(5)
    for name in tlm.QUANT_KERNELS:
        din = tlm.kernel_shape(layer, name)[0]
        x = rng.randn(2, 5, din).astype(np.float32)
        want = np.asarray(jlm._dense(jnp.asarray(x), jlayer, name))
        tol = 1e-5 * np.abs(want).max()
        for got in (tlm._dense(torch.from_numpy(x), layer, name),
                    wq.wq_dequant_matmul(torch.from_numpy(x),
                                         getattr(layer, name),
                                         getattr(layer, name + "_scale"))):
            np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("spec", ["int8", "int4", "int4:g32"])
def test_plain_matches_dequantize_then_matmul(spec):
    """``wq_matmul_plain`` (the scale after the product, per channel)
    against the weight dequantized in full, ``x @ (q * s)``."""
    rng = np.random.RandomState(1)
    bits, group = tlm.parse_quantize_spec(spec)
    qmax = 127 if bits == 8 else 7
    k, n = 256, 96
    q = torch.from_numpy(rng.randint(-qmax, qmax + 1, (k, n)).astype(np.int8))
    s = torch.from_numpy(
        (rng.rand(k // group if group else 1, n) * 0.01 + 1e-3).astype(
            np.float32))
    full = q.float() * s.repeat_interleave(k // s.shape[0], dim=0)
    if not group:
        s = s[0]
    w = tlm.pack_int4(q) if bits == 4 else q
    x = torch.from_numpy(rng.randn(7, k).astype(np.float32))
    want = (x @ full).numpy()
    got = wq.wq_matmul_plain(x, w, s)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)
    assert torch.equal(wq.wq_matmul(x, w, s), got)  # CPU: the plain version


def test_pack_int4_along_the_output_axis():
    """A packed int4 kernel [K, N / 2]: byte j of a row holds column 2j in
    its low nibble and 2j + 1 in its high one; unpacking gives the
    integers back."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randint(-7, 8, (40, 64)).astype(np.int8))
    w = tlm.pack_int4(q)
    assert w.dtype == torch.uint8 and tuple(w.shape) == (40, 32)
    assert torch.equal(wq.weight_ints(w), q)
    lo = (w.to(torch.int16) & 15).to(torch.int8)
    assert torch.equal(torch.where(lo > 7, lo - 16, lo), q[:, 0::2])
    assert torch.equal(wq.weight_ints(q), q)


@pytest.mark.parametrize("family, spec", [
    ("qwen25vl", "int8"), ("qwen25vl", "int4:g24"), ("llava_ov15", "int4"),
    ("llava_ov15", "int4:g32")])
def test_loader_carries_a_quantized_tree(trees, family, spec):
    """A quantized reference tree (int4 leaves as ``ml_dtypes`` int4)
    loads as the same integers and fp32 scales, held as buffers: the
    parameters hold no matmul kernel."""
    tree, cfg = trees[family]
    jq = _jax_quantized(trees, family, spec)
    if spec.startswith("int4"):
        assert jq["lm"]["layers"]["q_kernel"].dtype.name == "int4"
    got = _port(family, jq, cfg)
    want = tlm.apply_weight_quantization(_port(family, tree, cfg), spec)
    for lg, lw in zip(got.lm.layers, want.lm.layers):
        for name in tlm.QUANT_KERNELS:
            for suffix in ("", "_scale"):
                a, b = getattr(lg, name + suffix), getattr(lw, name + suffix)
                assert a.dtype == b.dtype and torch.equal(a, b)
        names = dict(lg.named_parameters())
        assert not any(n in names for n in tlm.QUANT_KERNELS)
    assert torch.equal(got.lm.embed_tokens, want.lm.embed_tokens)


@pytest.mark.parametrize("bits", [8, 4])
def test_init_lm_params_int8(bits):
    """Uniform integers in [-qmax, qmax] with one per-channel scale, 0.02
    over their std (the reference's rule); the other tensors as
    ``init_lm_params``; a prefill through it is finite."""
    cfg = four_layers(qwen25vl_tiny()).text
    lm = tlm.init_lm_params_int8(cfg, torch.Generator().manual_seed(0),
                                 "cpu", torch.float32, bits=bits)
    qmax = 127 if bits == 8 else 7
    std = np.sqrt(((2 * qmax + 1) ** 2 - 1) / 12.0)
    layer = lm.layers[0]
    for name in tlm.QUANT_KERNELS:
        w, s = getattr(layer, name), getattr(layer, name + "_scale")
        assert w.dtype == (torch.int8 if bits == 8 else torch.uint8)
        q = wq.weight_ints(w)
        assert tuple(q.shape) == tlm.kernel_shape(layer, name)
        assert q.abs().max() == qmax and q.min() == -qmax
        assert s.dtype == torch.float32 and s.dim() == 1
        assert torch.all(s == np.float32(0.02 / std))
    deq = wq.weight_ints(layer.gate_kernel).float() * layer.gate_kernel_scale
    assert abs(float(deq.std()) - 0.02) < 1e-3
    assert torch.all(layer.input_ln_scale == 1)
    t = 6
    h, _ = tlm.lm_prefill(lm, tlm.embed_tokens(lm, torch.arange(t))[None],
                          torch.arange(t).expand(3, 1, t),
                          torch.ones(1, t, dtype=torch.int32))
    assert torch.isfinite(h).all()


def _lm_forward(lm, t=8):
    ids = np.random.RandomState(1).randint(0, 1000, t)
    embeds = tlm.embed_tokens(lm, torch.from_numpy(ids))[None]
    pos = torch.arange(t).expand(3, 1, t)
    h, _ = tlm.lm_prefill(lm, embeds, pos, torch.ones(1, t, dtype=torch.int32))
    return h.numpy()


def _jax_lm_forward(params, cfg, t=8):
    ids = jnp.asarray(np.random.RandomState(1).randint(0, 1000, t))
    embeds = jlm.embed_tokens(params, ids)[None]
    pos = jnp.broadcast_to(jnp.arange(t), (3, 1, t))
    h, _ = jlm.lm_prefill(params, embeds, pos, jnp.ones((1, t), jnp.int32),
                          cfg)
    return np.asarray(h)


def test_lora_over_int8_base_matches_jax(trees):
    """Adapters over an int8 base: the forward equals the reference's with
    the same A and B, and the merge (dequantized base, the adapters'
    dtype, scales dropped) equals the reference's merged kernels; an int4
    base raises ValueError on merge and leaves the adapters in place."""
    tree, cfg = trees["qwen25vl"]
    jcfg = four_layers(jax_tiny()).text
    jq = jax.tree.map(jnp.asarray,
                      _jax_quantized(trees, "qwen25vl", "int8")["lm"])
    jl = jlora.add_lora_params(jq, jax.random.PRNGKey(3), rank=4, alpha=16)
    rng = np.random.RandomState(4)
    layers = dict(jl["layers"])
    for name in list(layers):
        if name.endswith("_lora_b"):
            layers[name] = jnp.asarray(
                rng.randn(*layers[name].shape).astype(np.float32) * 0.5)
    jl = dict(jl, layers=layers)
    lm = tlm.apply_weight_quantization(_port("qwen25vl", tree, cfg),
                                       "int8").lm
    base = _lm_forward(lm)
    tlora.add_lora_params(lm, torch.Generator().manual_seed(0), rank=4,
                          alpha=16)
    with torch.no_grad():
        for i, layer in enumerate(lm.layers):
            for name in tlm.QUANT_KERNELS:
                for ab in ("_lora_a", "_lora_b"):
                    getattr(layer, name + ab).copy_(torch.from_numpy(
                        np.array(jl["layers"][name + ab][i])))
    want = _jax_lm_forward(jl, jcfg)
    got = _lm_forward(lm)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(got - base).max() > 1e-2

    merged = jlora.merge_lora_params(jl)["layers"]
    tlora.merge_lora_params(lm)
    for i, layer in enumerate(lm.layers):
        for name in tlm.QUANT_KERNELS:
            w = dict(layer.named_parameters())[name]
            assert w.dtype == torch.float32
            assert not hasattr(layer, name + "_scale")
            np.testing.assert_allclose(w.numpy(), np.asarray(merged[name][i]),
                                       atol=1e-6, rtol=0)
    np.testing.assert_allclose(_lm_forward(lm), want, atol=1e-4, rtol=0)

    lm4 = tlm.apply_weight_quantization(_port("qwen25vl", tree, cfg),
                                        "int4").lm
    tlora.add_lora_params(lm4, torch.Generator().manual_seed(0), rank=4)
    with pytest.raises(ValueError, match="int4"):
        tlora.merge_lora_params(lm4)
    assert hasattr(lm4.layers[0], "q_kernel_lora_a")


def test_quantization_is_in_place_and_once(trees):
    """``apply_weight_quantization`` quantizes the LM it is given and
    returns the same parameters; the float kernels are gone, the
    quantized ones and their scales are in the state dict; quantizing
    again raises ValueError."""
    tree, cfg = trees["llava_ov15"]
    params = _port("llava_ov15", tree, cfg)
    before = copy.deepcopy(params.lm.layers[0].q_kernel)
    out = tlm.apply_weight_quantization(params, "int8")
    assert out is params and tlm.is_quantized(params.lm)
    sd = params.lm.state_dict()
    assert sd["layers.0.q_kernel"].dtype == torch.int8
    assert sd["layers.0.q_kernel_scale"].dtype == torch.float32
    assert "layers.0.q_kernel" not in dict(params.lm.named_parameters())
    deq = params.lm.layers[0].q_kernel.float() * \
        params.lm.layers[0].q_kernel_scale
    assert float((deq - before).abs().max()) <= float(
        params.lm.layers[0].q_kernel_scale.max()) / 2 * (1 + 1e-6)
    with pytest.raises(ValueError, match="already quantized"):
        tlm.apply_weight_quantization(params, "int4")
