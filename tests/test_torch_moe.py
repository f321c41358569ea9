"""The port's Qwen3-MoE decoder (LLaVA-OneVision-1.5's MoE variant) against
the JAX package's on ``llava_ov_moe_tiny`` (4 experts, top 2, expert width
64), fp32, with the same numpy weights and inputs made from a seed:

- the MoE MLP: the routed path (``lm._moe_mlp``: only the rows routed to
  each expert) and its dense plain version (``lm.moe_mlp_plain``) against
  the reference's ``_moe_mlp`` within 1e-5, with ``norm_topk_prob`` on and
  off, and with a zero router (every probability ties), where the chosen
  experts must be ``jax.lax.top_k``'s; the routed path's gradients equal
  the plain version's and ``jax.grad``'s within 1e-5 of each tensor's
  largest |value|;
- the decoder's prefill logits and a decode step within 1e-4;
- ``OVEngine.generate`` at budget 0.5: tokens and selected indices equal
  to the reference engine's;
- a synthetic HF MoE checkpoint: the port's load equal bit for bit to the
  reference's ``load_qwen3_lm_params``, the port's save / load round trip
  bit-equal, and ``api.predict --model-path`` on it equal to the engine;
- ``--quantize int8``: the quantized leaves are the reference's (the
  attention kernels, bit for bit; router and experts untouched);
- one OV selector training step: the loss within 1e-5 and the scorer
  gradients within 1e-4 of each tensor's largest |value| against
  ``jax.grad``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ov_params import (  # noqa: F401 (one_thread: autouse fixture)
    EOS,
    one_thread,
    ov_tree,
    requests,
)

from visionselector_tpu.core.config import llava_ov_moe_tiny as jax_moe_tiny
from visionselector_tpu.models.llava_ov15 import model as jmodel
from visionselector_tpu.models.llava_ov15 import weights as jweights
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu_torch.api import predict as tpredict
from visionselector_tpu_torch.core.config import llava_ov_moe_tiny
from visionselector_tpu_torch.core.safetensors import save_file
from visionselector_tpu_torch.models.llava_ov15 import model as tmodel
from visionselector_tpu_torch.models.llava_ov15 import weights as tweights
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl.weights import (
    load_lm_params,
)
from visionselector_tpu_torch.preprocess.image import preprocess_image
from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

MLP_ATOL = 1e-5
ATOL = 1e-4
EXPERT_LEAVES = ("router_kernel", "expert_gate_kernel", "expert_up_kernel",
                 "expert_down_kernel")


@pytest.fixture(scope="module")
def weights():
    tree = ov_tree(cfg=jax_moe_tiny())
    return (tree, jax.tree.map(jnp.asarray, tree),
            tweights.ov_from_jax_params(tree, llava_ov_moe_tiny(), "cpu"))


# -- the MoE MLP ---------------------------------------------------------


def _mlp_case(case):
    """(JAX text config, port text config, layer params as numpy, x)."""
    jcfg, tcfg = jax_moe_tiny().text, llava_ov_moe_tiny().text
    if case == "no norm_topk_prob":
        jcfg = dataclasses.replace(jcfg, norm_topk_prob=False)
        tcfg = dataclasses.replace(tcfg, norm_topk_prob=False)
    rng = np.random.RandomState(5)
    d, e, mi = tcfg.hidden_size, tcfg.num_experts, tcfg.moe_intermediate_size
    p = {"router_kernel": rng.randn(d, e),
         "expert_gate_kernel": rng.randn(e, d, mi) * 0.1,
         "expert_up_kernel": rng.randn(e, d, mi) * 0.1,
         "expert_down_kernel": rng.randn(e, mi, d) * 0.1}
    if case == "zero router":
        p["router_kernel"] = np.zeros((d, e))
    p = {n: a.astype(np.float32) for n, a in p.items()}
    x = rng.randn(2, 7, d).astype(np.float32)
    return jcfg, tcfg, p, x


def _port_layer(tcfg, p):
    layer = tlm.DecoderLayer(tcfg, "cpu", torch.float32)
    with torch.no_grad():
        for name, a in p.items():
            getattr(layer, name).copy_(torch.from_numpy(a))
    return layer


MLP_CASES = ["norm_topk_prob", "no norm_topk_prob", "zero router"]


@pytest.mark.parametrize("case", MLP_CASES)
def test_moe_mlp_matches_jax(case):
    jcfg, tcfg, p, x = _mlp_case(case)
    want = np.asarray(jlm._moe_mlp(jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, p), jcfg))
    layer = _port_layer(tcfg, p)
    xt = torch.from_numpy(x)
    routed = tlm._moe_mlp(xt, layer, tcfg)
    plain = tlm.moe_mlp_plain(xt, layer, tcfg)
    assert routed.shape == plain.shape == x.shape
    np.testing.assert_allclose(routed.numpy(), want, atol=MLP_ATOL, rtol=0)
    np.testing.assert_allclose(plain.numpy(), want, atol=MLP_ATOL, rtol=0)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router_kernel"]),
                           axis=-1)
    jv, ji = jax.lax.top_k(probs, jcfg.num_experts_per_tok)
    tv, ti = tlm.moe_route(xt, layer, tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if case == "zero router":  # every probability ties: the lowest ids
        assert (ti.numpy() == np.arange(tcfg.num_experts_per_tok)).all()
    if case != "no norm_topk_prob":
        np.testing.assert_allclose(tv.sum(-1).numpy(), 1.0, atol=1e-6)
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


def test_moe_mlp_routed_gradients_match_plain_and_jax():
    """The routed path under autograd: the gradients of a fixed projection
    of its output with respect to x, the router and the three expert
    kernels equal the dense plain version's and ``jax.grad`` of the
    reference's ``_moe_mlp`` (the router's through the softmax of the kept
    weights, as the reference differentiates it)."""
    jcfg, tcfg, p, x = _mlp_case("norm_topk_prob")
    proj = np.random.RandomState(6).randn(*x.shape).astype(np.float32)

    def jloss(pp, xx):
        return (jlm._moe_mlp(xx, pp, jcfg) * jnp.asarray(proj)).sum()

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    grads = {}
    for fn in (tlm._moe_mlp, tlm.moe_mlp_plain):
        layer = _port_layer(tcfg, p)
        for t in layer.parameters():
            t.requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        (fn(xt, layer, tcfg) * torch.from_numpy(proj)).sum().backward()
        grads[fn] = {n: getattr(layer, n).grad.numpy() for n in p}
        grads[fn]["x"] = xt.grad.numpy()
    want = dict(jax.tree.map(np.asarray, jg), x=np.asarray(jgx))
    assert np.abs(want["router_kernel"]).max() > 0
    for name, w in want.items():
        for fn in grads:
            assert _rel(grads[fn][name], w) < 1e-5, (fn.__name__, name)


# -- the decoder ---------------------------------------------------------


def _prefill_inputs(cfg):
    rng = np.random.RandomState(3)
    t, valid = 24, 19
    embeds = (rng.randn(1, t, cfg.hidden_size) * 8).astype(np.float32)
    pos = np.tile(np.arange(t), (3, 1))[:, None]
    seg = (np.arange(t) < valid).astype(np.int32)[None]
    return embeds, pos, seg, valid


def test_moe_decoder_prefill_and_decode_step_match_jax(weights):
    """Prefill logits over the valid rows, then one decode step at
    position ``valid`` over the prefill's cache, within 1e-4."""
    tree, jp, tp = weights
    jtext, lm = jax_moe_tiny().text, tp.lm
    embeds, pos, seg, v = _prefill_inputs(jtext)
    jh, (jk, jv) = jlm.lm_prefill(jp["lm"], jnp.asarray(embeds),
                                  jnp.asarray(pos), jnp.asarray(seg), jtext)
    th, _ = tlm.lm_prefill(lm, torch.from_numpy(embeds),
                           torch.from_numpy(pos), torch.from_numpy(seg))
    np.testing.assert_allclose(
        tlm.lm_head(lm, th[0, :v]).numpy(),
        np.asarray(jlm.lm_head(jp["lm"], jh[0, :v], jtext)), atol=ATOL,
        rtol=0)
    t_max, nl = 32, jtext.num_hidden_layers
    pad = ((0, 0), (0, 0), (0, t_max - jk.shape[2]), (0, 0), (0, 0))
    jcache = jlm.KVCache(k=jnp.pad(jk, pad), v=jnp.pad(jv, pad),
                         length=jnp.full((nl, 1), v, jnp.int32))
    x = (np.random.RandomState(9).randn(1, 1, jtext.hidden_size) * 8
         ).astype(np.float32)
    pos3 = np.full((3, 1, 1), v, np.int64)
    jh, _ = jlm.lm_decode_step(jp["lm"], jcache, jnp.asarray(x),
                               jnp.asarray(pos3), jtext)
    tcache = tlm.KVCache(k=torch.from_numpy(np.array(jcache.k)),
                         v=torch.from_numpy(np.array(jcache.v)),
                         length=torch.full((nl, 1), v, dtype=torch.int64))
    th, tcache = tlm.lm_decode_step(lm, tcache, torch.from_numpy(x),
                                    torch.from_numpy(pos3))
    np.testing.assert_allclose(
        tlm.lm_head(lm, th[0, 0]).numpy(),
        np.asarray(jlm.lm_head(jp["lm"], jh[0, 0], jtext)), atol=ATOL,
        rtol=0)
    assert int(tcache.length[0, 0]) == v + 1


def test_moe_engine_generate_matches_jax(weights):
    """The reference's ``test_moe_engine_generate`` request (budget 0.5,
    8 greedy tokens) on both engines: selected indices bit-equal, tokens
    equal, and the MoE layers are what ran."""
    _, jp, tp = weights
    assert "router_kernel" in dict(tp.lm.layers[0].named_parameters())
    r = requests()["image"]
    want = jmodel.OVEngine(jax_moe_tiny(), jp, use_selector=True,
                           budget=0.5).generate(**r, max_new_tokens=8,
                                                eos_token_ids=EOS)
    got = tmodel.OVEngine(llava_ov_moe_tiny(), tp, use_selector=True,
                          budget=0.5, device="cpu").generate(
        **r, max_new_tokens=8, eos_token_ids=EOS)
    np.testing.assert_array_equal(got.selected_indices,
                                  want.selected_indices)
    assert got.tokens == want.tokens
    assert len(set(got.tokens)) > 1


# -- weights -------------------------------------------------------------


def _hf_moe_tensors(cfg, seed):
    """A synthetic HF Qwen3-MoE text checkpoint (``model.`` prefix, nn.Linear
    layouts, non-trivial norm scales)."""
    rng = np.random.RandomState(seed)
    d, e, mi = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    dh, hq, hkv = (cfg.head_dim, cfg.num_attention_heads,
                   cfg.num_key_value_heads)

    def r(*shape):
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    out = {"model.embed_tokens.weight": r(cfg.vocab_size, d),
           "model.norm.weight": 1 + r(d)}
    for i in range(cfg.num_hidden_layers):
        pfx = f"model.layers.{i}."
        out.update({
            pfx + "input_layernorm.weight": 1 + r(d),
            pfx + "post_attention_layernorm.weight": 1 + r(d),
            pfx + "self_attn.q_proj.weight": r(hq * dh, d),
            pfx + "self_attn.k_proj.weight": r(hkv * dh, d),
            pfx + "self_attn.v_proj.weight": r(hkv * dh, d),
            pfx + "self_attn.o_proj.weight": r(d, hq * dh),
            pfx + "self_attn.q_norm.weight": 1 + r(dh),
            pfx + "self_attn.k_norm.weight": 1 + r(dh),
            pfx + "mlp.gate.weight": r(e, d)})
        for j in range(e):
            q = f"{pfx}mlp.experts.{j}."
            out.update({q + "gate_proj.weight": r(mi, d),
                        q + "up_proj.weight": r(mi, d),
                        q + "down_proj.weight": r(d, mi)})
    return out


def test_moe_hf_checkpoint_loads_like_jax_and_round_trips(tmp_path):
    """The port's ``load_lm_params`` on a synthetic HF MoE checkpoint
    equals the reference's ``load_qwen3_lm_params`` bit for bit (the
    experts stacked along their first axis), and ``lm_hf_tensors`` writes
    back every tensor of the file, bit for bit."""
    cfg = llava_ov_moe_tiny().text
    src = _hf_moe_tensors(cfg, seed=1)
    save_file({n: torch.from_numpy(a) for n, a in src.items()},
              str(tmp_path / "model.safetensors"))
    get = jweights._open_checkpoint(str(tmp_path))
    jtree = jweights.load_qwen3_lm_params(get, jax_moe_tiny().text,
                                          jnp.float32, "model.")
    for name in EXPERT_LEAVES:
        assert name in jtree["layers"]
    got = load_lm_params(tweights.open_checkpoint(str(tmp_path)), cfg,
                         "cpu", torch.float32)
    want = tweights.lm_from_jax(jax.tree.map(np.asarray, jtree), cfg, "cpu",
                                torch.float32)
    got_sd, want_sd = got.state_dict(), want.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for name in got_sd:
        assert torch.equal(got_sd[name], want_sd[name]), name
    back = tweights.lm_hf_tensors(got)
    assert back.keys() == src.keys()
    for name, a in src.items():
        np.testing.assert_array_equal(back[name].numpy(), a, err_msg=name)


def test_moe_ov_checkpoint_round_trip_and_predict(tmp_path, capsys,
                                                  weights):
    """``save_ov_checkpoint`` of the MoE model writes the MoE fields into
    config.json; ``load_ov_checkpoint`` reads back every tensor bit for
    bit; ``api.predict --family llava_ov15 --model-path`` on the directory
    gives the engine's tokens."""
    _, _, tp = weights
    cfg = llava_ov_moe_tiny()
    tweights.save_ov_checkpoint(tp, cfg, str(tmp_path), shards=2)
    with open(tmp_path / "config.json") as f:
        text = json.load(f)["text_config"]
    assert (text["num_experts"], text["num_experts_per_tok"],
            text["moe_intermediate_size"]) == (4, 2, 64)
    hf_cfg = tweights.ov_config_from_hf(str(tmp_path))
    assert hf_cfg.text == cfg.text
    back = tweights.load_ov_checkpoint(str(tmp_path), hf_cfg, "cpu",
                                       dtype=torch.float32)
    for (name, a), (_, b) in zip(tp.state_dict().items(),
                                 back.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert tpredict.main(["--family", "llava_ov15", "--device", "cpu",
                          "--model-path", str(tmp_path), "--prompt-ids",
                          "5,6,7", "--max-new-tokens", "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    img = (np.random.RandomState(0).rand(112, 112, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9,
                                temporal_patch_size=1)
    params = tweights.load_ov_checkpoint(str(tmp_path), hf_cfg, "cpu")
    want = tmodel.OVEngine(hf_cfg, params, device="cpu").generate(
        expand_vision_tokens([], [5, 6, 7], grid), px, grid,
        max_new_tokens=4)
    assert out["tokens"] == want.tokens


def test_moe_quantize_int8_matches_jax(weights):
    """``--quantize int8`` on the MoE tree: the quantized leaves are the
    reference's (its ``quantize_lm_params`` skips the kernels an MoE layer
    lacks), integers and scales bit for bit; router and experts keep their
    values and dtype."""
    tree, jp, _ = weights
    want = jax.tree.map(np.asarray, jlm.apply_weight_quantization(
        jax.tree.map(jnp.asarray, tree), "int8"))["lm"]["layers"]
    params = tweights.ov_from_jax_params(tree, llava_ov_moe_tiny(), "cpu")
    tlm.apply_weight_quantization(params, "int8")
    quantized = {n for n in tlm.QUANT_KERNELS if n + "_scale" in want}
    for i, layer in enumerate(params.lm.layers):
        assert set(tlm.quant_kernel_names(layer)) == quantized == {
            "q_kernel", "k_kernel", "v_kernel", "o_kernel"}
        for name in quantized:
            assert getattr(layer, name).dtype == torch.int8
            np.testing.assert_array_equal(getattr(layer, name).numpy(),
                                          want[name][i])
            np.testing.assert_array_equal(
                getattr(layer, name + "_scale").numpy(),
                want[name + "_scale"][i])
        for name in EXPERT_LEAVES:
            t = getattr(layer, name)
            assert t.dtype == torch.float32 and isinstance(
                t, torch.nn.Parameter)
            np.testing.assert_array_equal(t.detach().numpy(), want[name][i])
    assert tlm.is_quantized(params.lm)


# -- training ------------------------------------------------------------


def test_moe_ov_selector_train_step_matches_jax(weights):
    """One OV selector step's loss (fp32, O(1): 1e-5) and the scorer
    gradients of ``batch_loss`` (1e-4 of each tensor's largest |value|)
    against ``jax.grad`` on the MoE decoder."""
    from visionselector_tpu.train import data as jdata
    from visionselector_tpu.train import ov_loss as jov
    from visionselector_tpu.train import train_step as jstep
    from visionselector_tpu_torch.train import data as tdata
    from visionselector_tpu_torch.train import loss as tloss
    from visionselector_tpu_torch.train import ov_loss as tov
    from visionselector_tpu_torch.train import train_step as tstep

    tree, jp, _ = weights
    img = (np.random.RandomState(4).rand(112, 112, 3) * 255).astype(np.uint8)
    kw = dict(prompt_before=[101, 102], prompt_after=[103],
              answer_ids=[201, 202, 203], budget=0.5, s_bucket=64,
              t_bucket=64)
    k_max = 8
    jb = jax.tree.map(jnp.asarray, jdata.stack_samples(
        [jov.build_ov_train_sample(jax_moe_tiny(), img, **kw)]))
    tb = tloss.to_device(tdata.stack_samples(
        [tov.build_ov_train_sample(llava_ov_moe_tiny(), img, **kw)]), "cpu")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda sp, fp, b_: jstep.batch_loss(sp, fp, b_, jax_moe_tiny(),
                                            jnp.asarray(1.3), k_max),
        has_aux=True))(jp["scorer"], jp, jb)
    params = tweights.ov_from_jax_params(tree, llava_ov_moe_tiny(), "cpu")
    tstep.init_train_state(params, tstep.ScheduleConfig())
    loss, _ = tstep.batch_loss(params, tb, llava_ov_moe_tiny(), 1.3, k_max)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5, rtol=0)
    top = max(float(np.abs(jg[n]).max()) for n in jg)
    assert top > 0
    for name, p in params.scorer.named_parameters():
        if name == "q_bias":  # shifts every score alike: zero on both sides
            assert np.abs(jg[name]).max() < 1e-6 * top
            assert p.grad.abs().max() < 1e-6 * top
        else:
            assert _rel(p.grad.numpy(), jg[name]) < 1e-4, name
    assert all(p.grad is None for p in params.lm.parameters())
