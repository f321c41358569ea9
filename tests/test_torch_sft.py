"""The port's SFT (``--method sft``) and LoRA against the JAX package's on
the tiny configs with 4 decoder layers: the freeze policy
(``trainable_mask``), the CE and the gradients of LM, merger and ViT
leaves under each ``--tune-mm-*`` setting (through the window layers'
diag kernel and the full layers' flash kernel, both through
``FlashAttentionFn``), the OV
family through ``forward_logits``' dispatch, LoRA (a no-op at init, the
adapter forward, the merge, the adapter term's dtype on bf16), three
optimizer steps against optax, gradient accumulation, and a resume with
and without the background writer.

Weights come from ``jax_param_tree`` / ``ov_tree`` (numpy); fp32
throughout but the dtype check. Tolerances are stated where used: fp32
sum-order differences relative to each tensor's largest |value|, or
absolute where the values are O(1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ov_params import one_thread, ov_tree  # noqa: F401 (autouse)
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import llava_ov_tiny as jax_ov_tiny
from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu.train import data as jdata
from visionselector_tpu.train import lora as jlora
from visionselector_tpu.train import ov_loss as jov
from visionselector_tpu.train import sft as jsft
from visionselector_tpu_torch.core import checkpoint as tckpt
from visionselector_tpu_torch.core.config import llava_ov_tiny, qwen25vl_tiny
from visionselector_tpu_torch.models.llava_ov15.weights import (
    ov_from_jax_params,
)
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.train import data as tdata
from visionselector_tpu_torch.train import lora as tlora
from visionselector_tpu_torch.train import loss as tloss
from visionselector_tpu_torch.train import ov_loss as tov
from visionselector_tpu_torch.train import sft as tsft

S_BUCKET, T_BUCKET = 128, 64
IMAGES = [(112, 112), (84, 112)]
RANK, ALPHA = 4, 8
# leaves whose gradients are compared: decoder, embedding (tied head),
# merger, a window block (0: the diag kernel's Function) and a full one (1)
CHECK = ("lm.layers.0.q_kernel", "lm.layers.3.down_kernel",
         "lm.embed_tokens", "visual.merger_fc1_kernel",
         "visual.blocks.0.qkv_kernel", "visual.blocks.1.qkv_kernel",
         "visual.patch_embed_kernel")
FREEZE = {
    "llm": dict(),
    "vision": dict(tune_mm_vision=True, tune_mm_llm=False),
    "mlp": dict(tune_mm_mlp=True, tune_mm_llm=False),
    "all": dict(tune_mm_vision=True, tune_mm_mlp=True),
}


def _rel_err(got, want):
    """max |got - want| over the largest |want|."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def four_layers(cfg):
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=4))


def jax_leaf(tree, name):
    """The JAX tree's array for a port parameter name (stacked layers and
    blocks sliced)."""
    parts = name.split(".")
    node = tree[parts[0]]
    if len(parts) == 4:  # lm.layers.<i>.<leaf> / visual.blocks.<i>.<leaf>
        return np.asarray(node[parts[1]][parts[3]])[int(parts[2])]
    return np.asarray(node[parts[1]])


def nested(named):
    """{port name: value} as {first component: {rest: value}}: a tree whose
    paths start as the reference's (``visual/merger...``, ``lm/...``), for
    the reference's path-based masks."""
    out = {}
    for name, v in named.items():
        head, rest = name.split(".", 1)
        out.setdefault(head, {})[rest] = v
    return out


@pytest.fixture(scope="module")
def model():
    jcfg = four_layers(jax_tiny())
    tree = jax_param_tree(jcfg, seed=5, scorer_std=0.02)
    return jcfg, jax.tree.map(jnp.asarray, tree), tree


def _port(tree):
    return from_jax_params(tree, four_layers(qwen25vl_tiny()), "cpu")


def _batches(n=2, seed=0):
    rng = np.random.RandomState(seed)
    js, ts = [], []
    for i in range(n):
        img = (rng.rand(*IMAGES[i % 2], 3) * 255).astype(np.uint8)
        kw = dict(prompt_before=[101, 102], prompt_after=[103],
                  answer_ids=[201 + i, 202, 203, 204][: 3 + i % 2],
                  budget=0.25, s_bucket=S_BUCKET, t_bucket=T_BUCKET,
                  min_pixels=1, max_pixels=10**9)
        js.append(jdata.build_train_sample(jax_tiny(), img, **kw))
        ts.append(tdata.build_train_sample(qwen25vl_tiny(), img, **kw))
    return (jax.tree.map(jnp.asarray, jdata.stack_samples(js)),
            tloss.to_device(tdata.stack_samples(ts), "cpu"))


@pytest.fixture(scope="module")
def batches():
    return _batches()


def _jax_batch_loss(params, jb, jcfg):
    losses, _ = jax.vmap(lambda s: jsft.sft_train_forward(params, s, jcfg))(
        jb)
    return losses.mean()


@pytest.fixture(scope="module")
def jax_grads(model, batches):
    """The reference's batch CE and its gradient for every leaf."""
    jcfg, jparams, _ = model
    return jax.jit(jax.value_and_grad(
        lambda p: _jax_batch_loss(p, batches[0], jcfg)))(jparams)


@pytest.mark.parametrize("sched", [
    dict(), dict(tune_mm_vision=True), dict(tune_mm_mlp=True,
                                            tune_mm_llm=False),
    dict(tune_mm_vision=True, tune_mm_mlp=True), dict(lora_rank=RANK)])
def test_trainable_mask_matches_jax(model, sched):
    """The parameters marked trainable, by name with the layer index
    dropped, equal the reference's ``trainable_mask`` (its LoRA scale
    leaves, which the port keeps as a plain number, never train)."""
    _, _, tree = model
    params = _port(tree)
    if sched.get("lora_rank"):
        tlora.add_lora_params(params.lm, torch.Generator().manual_seed(0),
                              rank=RANK, alpha=ALPHA)
        tree = dict(tree, lm=jlora.add_lora_params(
            tree["lm"], jax.random.PRNGKey(0), rank=RANK, alpha=ALPHA))
    got = {".".join(p for p in n.split(".") if not p.isdigit())
           for n, on in tsft.trainable_mask(
               params, tsft.SFTScheduleConfig(**sched)).items() if on}
    jmask = jsft.trainable_mask(tree, jsft.SFTScheduleConfig(**sched))
    want = {".".join(str(getattr(k, "key", k)) for k in path)
            for path, on in jax.tree_util.tree_flatten_with_path(jmask)[0]
            if on}
    assert got == want and got


@pytest.mark.parametrize("freeze", list(FREEZE))
def test_sft_gradients_match_jax(model, batches, jax_grads, freeze):
    """The batch CE within 1e-5 of the reference's, and each trainable
    checked leaf's gradient within 1e-4 of its max |value| against
    ``jax.grad``; frozen leaves get none. The vision tower runs with grad
    only when it trains."""
    _, _, tree = model
    jloss, want = jax_grads
    params = _port(tree)
    state = tsft.init_sft_state(params, tsft.SFTScheduleConfig(
        **FREEZE[freeze]))
    losses, metrics = tsft.sft_batch_forward(
        params, batches[1], four_layers(qwen25vl_tiny()))
    losses.mean().backward()
    np.testing.assert_allclose(float(losses.mean().detach()), float(jloss),
                               atol=1e-5, rtol=0)
    assert torch.equal(losses, metrics["ce"])
    named = dict(params.named_parameters())
    for name in CHECK:
        p = named[name]
        if name in state.trainables:
            assert _rel_err(p.grad.numpy(), jax_leaf(want, name)) < 1e-4, \
                name
        else:
            assert p.grad is None, name


def test_ov_sft_gradients_match_jax():
    """The OV family through the sample-type dispatch, the RICE tower and
    the decoder training: the batch CE within 1e-5 of the reference's and
    the gradients of a RICE block's and a decoder layer's kernels within
    1e-4 of their max |value|; ``forward_logits`` equals
    ``ov_forward_logits``."""
    jcfg, tcfg = four_layers(jax_ov_tiny()), four_layers(llava_ov_tiny())
    tree = ov_tree(layers=4)
    rng = np.random.RandomState(4)
    js, ts = [], []
    for i in range(2):
        img = (rng.rand(56, 56, 3) * 255).astype(np.uint8)
        kw = dict(prompt_before=[101, 102], prompt_after=[103],
                  answer_ids=[201 + i, 202, 203], budget=0.5, s_bucket=64,
                  t_bucket=64)
        js.append(jov.build_ov_train_sample(jax_ov_tiny(), img, **kw))
        ts.append(tov.build_ov_train_sample(llava_ov_tiny(), img, **kw))
    jb = jax.tree.map(jnp.asarray, jdata.stack_samples(js))
    tb = tloss.to_device(tdata.stack_samples(ts), "cpu")
    jl, want = jax.jit(jax.value_and_grad(
        lambda p: _jax_batch_loss(p, jb, jcfg)))(
        jax.tree.map(jnp.asarray, tree))
    params = ov_from_jax_params(tree, tcfg, "cpu")
    tsft.init_sft_state(params, tsft.SFTScheduleConfig(tune_mm_vision=True))
    losses, _ = tsft.sft_batch_forward(params, tb, tcfg)
    losses.mean().backward()
    np.testing.assert_allclose(float(losses.mean().detach()), float(jl),
                               atol=1e-5, rtol=0)
    named = dict(params.named_parameters())
    for name in ("visual.blocks.0.qkv_kernel", "lm.layers.1.q_kernel",
                 "lm.embed_tokens"):
        assert _rel_err(named[name].grad.numpy(),
                        jax_leaf(want, name)) < 1e-4, name
    one = tov.OVTrainSample(*(np.asarray(x)[0] if f in tov.HOST_FIELDS
                              else x[0] for f, x in tb._asdict().items()))
    with torch.no_grad():
        assert torch.equal(tsft.forward_logits(params, one, tcfg),
                           tov.ov_forward_logits(params, one, tcfg))


def _with_jax_adapters(tree, params, seed=3):
    """The reference tree with adapters (A from its own init, B random so
    the adapters act), the same values copied into the port's."""
    lm = jlora.add_lora_params(tree["lm"], jax.random.PRNGKey(seed),
                               rank=RANK, alpha=ALPHA)
    rng = np.random.RandomState(seed)
    layers = dict(lm["layers"])
    for name in tlora.DEFAULT_TARGETS:
        b = np.asarray(layers[name + "_lora_b"])
        layers[name + "_lora_b"] = (rng.randn(*b.shape) * 0.05).astype(
            np.float32)
        layers[name + "_lora_a"] = np.asarray(layers[name + "_lora_a"])
    tree = dict(tree, lm=dict(lm, layers=layers))
    tlora.add_lora_params(params.lm, torch.Generator().manual_seed(0),
                          rank=RANK, alpha=ALPHA)
    with torch.no_grad():
        for i, layer in enumerate(params.lm.layers):
            for name in tlora.DEFAULT_TARGETS:
                for s in ("_lora_a", "_lora_b"):
                    getattr(layer, name + s).copy_(torch.from_numpy(
                        np.array(layers[name + s][i])))
    return tree


def test_lora_noop_adapter_forward_and_merge_match_jax(model, batches):
    """Fresh adapters (B = 0) leave the logits bit-equal; with acting
    adapters the logits within 1e-4 of the reference's adapter forward;
    the merged kernels within 1e-6 of the reference's merge, the merged
    model's logits within 1e-4 of the adapter model's, and no adapter
    left."""
    jcfg, _, tree = model
    jb, tb = batches
    cfg = four_layers(qwen25vl_tiny())
    one = tloss.TrainBatchSample(*(
        np.asarray(x)[0] if f in tloss.HOST_FIELDS else x[0]
        for f, x in tb._asdict().items()))
    params = _port(tree)
    with torch.no_grad():
        base = tsft.forward_logits(params, one, cfg)
        tlora.add_lora_params(params.lm, torch.Generator().manual_seed(1),
                              rank=RANK, alpha=ALPHA)
        assert torch.equal(tsft.forward_logits(params, one, cfg), base)
    params = _port(tree)
    jtree = _with_jax_adapters(tree, params)
    js = jax.tree.map(lambda x: x[0], jb)
    want = np.asarray(jax.jit(lambda p, s: jsft.sft_forward_logits(
        p, s, jcfg))(jax.tree.map(jnp.asarray, jtree), js))
    n = int(np.asarray(one.seg_ids).sum())
    with torch.no_grad():
        adapted = tsft.forward_logits(params, one, cfg)
        np.testing.assert_allclose(adapted[:n].numpy(), want[:n], atol=1e-4,
                                   rtol=0)
        tlora.merge_lora_params(params.lm)
        merged = tsft.forward_logits(params, one, cfg)
    np.testing.assert_allclose(merged[:n].numpy(), adapted[:n].numpy(),
                               atol=1e-4, rtol=0)
    jmerged = jlora.merge_lora_params(jax.tree.map(jnp.asarray,
                                                   jtree["lm"]))
    for i, layer in enumerate(params.lm.layers):
        assert not any(tlora.lora_leaf(n) for n, _ in
                       layer.named_parameters())
        for name in tlora.DEFAULT_TARGETS:
            np.testing.assert_allclose(
                getattr(layer, name).detach().numpy(),
                np.asarray(jmerged["layers"][name])[i], atol=1e-6, rtol=0)


def test_lora_gradients_match_jax(model, batches):
    """LoRA SFT (acting adapters, the base frozen): the batch CE within
    1e-5 of the reference's on the same adapters, each adapter's gradient
    within 1e-4 of its max |value| against ``jax.grad``; the base weights
    get none."""
    jcfg, _, tree = model
    jb, tb = batches
    params = _port(tree)
    jtree = jax.tree.map(jnp.asarray, _with_jax_adapters(tree, params))
    jl, want = jax.jit(jax.value_and_grad(
        lambda p: _jax_batch_loss(p, jb, jcfg)))(jtree)
    state = tsft.init_sft_state(params, tsft.SFTScheduleConfig(
        lora_rank=RANK))
    losses, _ = tsft.sft_batch_forward(params, tb,
                                       four_layers(qwen25vl_tiny()))
    losses.mean().backward()
    np.testing.assert_allclose(float(losses.mean().detach()), float(jl),
                               atol=1e-5, rtol=0)
    assert len(state.trainables) == 2 * len(tlora.DEFAULT_TARGETS) * 4
    for name, p in state.trainables.items():
        assert _rel_err(p.grad.numpy(), jax_leaf(want, name)) < 1e-4, name
    assert all(p.grad is None for n, p in params.named_parameters()
               if n not in state.trainables)


def test_lora_dense_dtype_on_bf16_against_jax():
    """On a bf16 tree the reference's ``_dense`` with adapters returns fp32
    (its fp32 scale leaf promotes the sum); the port's stays bf16 (the
    kernels after it take bf16) and equals the reference's value rounded
    to bf16 within one bf16 ulp of the row's largest |value| (ROADMAP
    section 3)."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 16).astype(np.float32)
    w = (rng.randn(1, 16, 8) * 0.2).astype(np.float32)
    jtree = jlora.add_lora_params(
        {"layers": {"q_kernel": jnp.asarray(w, jnp.bfloat16)}},
        jax.random.PRNGKey(0), rank=RANK, alpha=ALPHA,
        targets=("q_kernel",), dtype=jnp.bfloat16)
    b = (rng.randn(1, RANK, 8) * 0.5).astype(np.float32)
    jtree["layers"]["q_kernel_lora_b"] = jnp.asarray(b, jnp.bfloat16)
    jp = jax.tree.map(lambda a: a[0], jtree["layers"])
    want = jlm._dense(jnp.asarray(x, jnp.bfloat16), jp, "q_kernel")
    assert want.dtype == jnp.float32

    class Layer(torch.nn.Module):
        pass

    layer = Layer()
    for name in ("q_kernel", "q_kernel_lora_a", "q_kernel_lora_b"):
        layer.register_parameter(name, torch.nn.Parameter(torch.from_numpy(
            np.array(jp[name].astype(jnp.float32))).bfloat16(),
            requires_grad=False))
    layer.lora_scale = ALPHA / RANK
    got = tlm._dense(torch.from_numpy(x).bfloat16(), layer, "q_kernel")
    assert got.dtype == torch.bfloat16
    ref = np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max(-1, keepdims=True))) - 7)
    assert (np.abs(got.float().numpy() - ref) <= ulp).all()


def _port_steps(params, state, tb, sched, n=3):
    """``n`` port steps: per step (metrics, the trainables' gradients
    before the step, their values before, their values after)."""
    cfg = four_layers(qwen25vl_tiny())
    out = []

    def values():
        return {k: v.detach().clone() for k, v in state.trainables.items()}

    for _ in range(n):
        losses, _ = tsft.sft_batch_forward(params, tb, cfg)
        grads = torch.autograd.grad(losses.mean(),
                                    list(state.trainables.values()))
        grads = dict(zip(state.trainables, (g.numpy() for g in grads)))
        before = values()
        state, m = tsft.sft_train_step(state, params, tb, cfg, sched)
        out.append(({k: float(v) for k, v in m.items()}, grads, before,
                    values()))
    return out


@pytest.mark.parametrize("kind", ["llm", "lora"])
def test_sft_three_steps_match_optax(model, batches, kind):
    """Three steps from the same parameters (the decoder, or LoRA
    adapters): each step's update equals the reference's optimizer
    (``sft.make_optimizer``: optax's masked clip + adamw, applied to a tree
    of the port's parameters) on the port's own gradients, within 1e-4 of
    the update's max |value|; lr 0 at the first step; the losses finite
    and falling. The updates are held to optax on the port's gradients,
    not to the reference's whole step (Adam's per-element division; see
    ``test_torch_ov_train.test_ov_three_steps_match_optax``); the
    gradients themselves are held to ``jax.grad`` by
    ``test_sft_gradients_match_jax`` and
    ``test_lora_gradients_match_jax``. The clip threshold sits between the
    first and the last step's norm, so some steps clip and others do
    not."""
    _, _, tree = model
    _, tb = batches
    lora = dict(lora_rank=RANK) if kind == "lora" else {}

    def setup():
        params = _port(tree)
        if lora:
            _with_jax_adapters(tree, params)
        return params

    params = setup()
    free = tsft.SFTScheduleConfig(total_steps=3, lr=5e-3, max_grad_norm=0.0,
                                  **lora)
    norms = [m["grad_norm"] for m, *_ in _port_steps(
        params, tsft.init_sft_state(params, free), tb, free)]
    clip = (norms[0] + norms[-1]) / 2
    sched = tsft.SFTScheduleConfig(total_steps=3, lr=5e-3,
                                   max_grad_norm=clip, **lora)
    jsched = jsft.SFTScheduleConfig(total_steps=3, lr=5e-3,
                                    max_grad_norm=clip, **lora)
    params = setup()
    state = tsft.init_sft_state(params, sched)
    names = [n for n, _ in params.named_parameters()]
    ptree = nested({n: jnp.asarray(p.detach().numpy())
                    for n, p in params.named_parameters()})
    opt = jsft.make_optimizer(ptree, jsched)
    opt_state = opt.init(ptree)
    update = jax.jit(opt.update)
    port = _port_steps(params, state, tb, sched)
    losses = [m["loss"] for m, *_ in port]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    clipped = []
    for i, (m, grads, before, after) in enumerate(port):
        full = dict.fromkeys(names)
        for n in names:
            full[n] = jnp.asarray(grads[n] if n in grads else np.zeros(
                ptree[n.split(".", 1)[0]][n.split(".", 1)[1]].shape,
                np.float32))
        updates, opt_state = update(nested(full), opt_state, ptree)
        ptree = nested({n: jnp.asarray(after[n].numpy()) if n in after
                        else ptree[n.split(".", 1)[0]][n.split(".", 1)[1]]
                        for n in names})
        for name in grads:
            u = np.asarray(updates[name.split(".", 1)[0]][
                name.split(".", 1)[1]])
            got = (after[name] - before[name]).numpy()
            if i == 0:
                assert m["lr"] == 0.0 and not got.any()
            elif np.abs(u).max() > 0:
                assert _rel_err(got, u) < 1e-4, (i, name)
            else:  # LoRA's A at step 2: B was 0, so its gradient is 0
                assert not got.any(), (i, name)
        clipped.append(m["grad_norm"] >= clip)
    assert len(set(clipped)) == 2, clipped


def test_sft_accum_equals_big_batch(model):
    """``sft_train_step_accum`` over two micro-batches of one sample equals
    ``sft_train_step`` on the batch of two (the trainables within 1e-6 of
    their max |value|, the same loss)."""
    _, _, tree = model
    _, tb = _batches(2, seed=1)
    cfg = four_layers(qwen25vl_tiny())
    sched = tsft.SFTScheduleConfig(total_steps=4, lr=5e-3, tune_mm_mlp=True,
                                   tune_mm_llm=False)
    micro = [tloss.TrainBatchSample(*(
        np.asarray(x)[i:i + 1] if f in tloss.HOST_FIELDS else x[i:i + 1]
        for f, x in tb._asdict().items())) for i in range(2)]
    results = []
    for accum in (False, True):
        params = _port(tree)
        state = tsft.init_sft_state(params, sched)
        for _ in range(2):
            if accum:
                state, m = tsft.sft_train_step_accum(state, params, micro,
                                                     cfg, sched)
            else:
                state, m = tsft.sft_train_step(state, params, tb, cfg, sched)
        results.append((float(m["loss"]), state.trainables))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-6)
    for n, a in results[0][1].items():
        assert _rel_err(results[1][1][n].detach().numpy(),
                        a.detach().numpy()) < 1e-6, n


@pytest.mark.parametrize("async_save", [False, True])
def test_sft_resume_equals_uninterrupted(model, batches, tmp_path,
                                         async_save):
    """LoRA SFT: three steps straight, against two steps, a checkpoint
    (the background writer's, joined, or written in the foreground), a
    restore into a fresh state and a third step: the adapters bit-equal,
    the checkpoint holding the adapters only."""
    _, _, tree = model
    _, tb = batches
    cfg = four_layers(qwen25vl_tiny())
    sched = tsft.SFTScheduleConfig(total_steps=3, lr=5e-3, lora_rank=RANK)

    def fresh():
        params = _port(tree)
        tlora.add_lora_params(params.lm, torch.Generator().manual_seed(2),
                              rank=RANK, alpha=ALPHA)
        return params, tsft.init_sft_state(params, sched)

    params, state = fresh()
    for _ in range(3):
        state, _ = tsft.sft_train_step(state, params, tb, cfg, sched)
    straight = {k: v.detach().clone() for k, v in state.trainables.items()}
    params, state = fresh()
    for _ in range(2):
        state, _ = tsft.sft_train_step(state, params, tb, cfg, sched)
    saver = tckpt.AsyncSaver() if async_save else None
    path = tckpt.save_train_state(state, str(tmp_path), saver=saver)
    if saver is not None:
        saver.finalize_saves()
    blob = torch.load(f"{path}/{tckpt.STATE_FILE}", weights_only=True)
    assert set(blob["params"]) == set(state.trainables)
    assert all(tlora.lora_leaf(n) for n in blob["params"])
    params, state2 = fresh()
    state2, resumed = tckpt.maybe_resume(str(tmp_path), state2)
    assert resumed and state2.step == 2
    state2, _ = tsft.sft_train_step(state2, params, tb, cfg, sched)
    for name, p in state2.trainables.items():
        assert torch.equal(p.detach(), straight[name]), name
