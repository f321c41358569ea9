"""The port's Dynamic-Qwen training (``--method dynamic``) against the JAX
package's on qwen25vl_tiny with 4 decoder layers (the predictor at layer
2): the temperature schedule, the straight-through Gumbel keep mask (its
values and gradient), the predictor under a partial policy, the batch
loss and the predictor's gradients, a resume (with and without the
background writer) and the predictor's export.

The port draws its Gumbel noise from a ``torch.Generator``; each test
hands both sides the uniforms ``jax.random.uniform`` draws for the
reference's key. The reference's training forward runs the predictor
with ``predictor_forward``'s default 8 heads, so the port's test
predictor has 8 heads too (ROADMAP section 3 quirk). Inputs come from
numpy seeds, fp32 throughout; tolerances are stated where used.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree
from torch_ov_params import one_thread  # noqa: F401 (autouse)

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.selector.baselines import dynamic as jdyn
from visionselector_tpu.train import data as jdata
from visionselector_tpu.train import dynamic_train as jdt
from visionselector_tpu_torch.core import checkpoint as tckpt
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl.weights import (
    from_jax_params,
    predictor_from_jax,
)
from visionselector_tpu_torch.selector.baselines import dynamic as tdyn
from visionselector_tpu_torch.train import data as tdata
from visionselector_tpu_torch.train import dynamic_train as tdt
from visionselector_tpu_torch.train import loss as tloss

S_BUCKET, T_BUCKET, BUDGET = 128, 64, 0.25
D_MODEL, HEADS = 64, 8
IMAGES = [(112, 112), (84, 112)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_err(got, want):
    """max |got - want| over the largest |want|."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def four_layers(cfg):
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=4))


@pytest.fixture(scope="module")
def model():
    jcfg = four_layers(jax_tiny())
    tree = jax_param_tree(jcfg, seed=5, scorer_std=0.02)
    pred = jax.tree.map(np.asarray, jdyn.init_predictor_params(
        jax.random.PRNGKey(1), jcfg.text.hidden_size, d_model=D_MODEL))
    return jcfg, jax.tree.map(jnp.asarray, tree), tree, pred


def _port(tree, pred):
    params = from_jax_params(tree, four_layers(qwen25vl_tiny()), "cpu")
    return params, predictor_from_jax(pred, "cpu", num_heads=HEADS)


@pytest.fixture(scope="module")
def batches():
    """(JAX batch on its classic layout, the port's on the aligned one) of
    two samples."""
    rng = np.random.RandomState(0)
    js, ts = [], []
    for i, hw in enumerate(IMAGES):
        img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        kw = dict(prompt_before=[101, 102], prompt_after=[103],
                  answer_ids=[201 + i, 202, 203, 204][: 3 + i],
                  budget=BUDGET, s_bucket=S_BUCKET, t_bucket=T_BUCKET,
                  min_pixels=1, max_pixels=10**9)
        js.append(jdata.build_train_sample(jax_tiny(), img, **kw))
        ts.append(tdata.build_train_sample(qwen25vl_tiny(), img, **kw))
    return (jax.tree.map(jnp.asarray, jdata.stack_samples(js)),
            tloss.to_device(tdata.stack_samples(ts), "cpu"))


def test_tau_schedule_matches_jax():
    """Within one fp32 rounding (1e-6 relative) of the reference's, the
    fraction clipped at both ends."""
    for step in (0, 1, 3, 50, 99, 100, 150):
        for start, end in ((1.0, 0.1), (2.0, 0.5)):
            np.testing.assert_allclose(
                tdyn.tau_schedule(step, 100, start, end),
                float(jdyn.tau_schedule(jnp.asarray(step), 100, start,
                                        end)), rtol=1e-6)


@pytest.mark.parametrize("tau", [1.0, 0.3])
def test_gumbel_keep_mask_and_st_gradient_match_jax(tau):
    """Given the reference's uniforms: the keep mask equal (within 1e-6:
    hard + soft - soft is 0 or 1 up to fp32 rounding), and the
    straight-through gradient (the soft sample's) within 1e-5 of its max
    |value| against ``jax.vjp``."""
    rng = np.random.RandomState(int(tau * 10))
    logits = rng.randn(3, 50, 2).astype(np.float32)
    g = rng.randn(3, 50).astype(np.float32)
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, logits.shape))
    want, vjp = jax.vjp(lambda x: jdyn.gumbel_keep_mask(key, x, tau),
                        jnp.asarray(logits))
    (want_dx,) = vjp(jnp.asarray(g))
    x = _t(logits).requires_grad_(True)
    got = tdyn.gumbel_keep_mask(x, tau, _t(u))
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    assert set(np.round(got.detach().numpy()).ravel()) == {0.0, 1.0}
    assert _rel_err(x.grad.numpy(), want_dx) < 1e-5


def test_predictor_partial_policy_matches_jax(model):
    """``predictor_forward`` with a policy that masks rows out of the
    global mean: logits within 1e-5 of the reference's."""
    _, _, _, pred = model
    rng = np.random.RandomState(2)
    x = rng.randn(2, 20, 96).astype(np.float32)
    policy = (rng.rand(2, 20, 1) > 0.4).astype(np.float32)
    want = jdyn.predictor_forward(jax.tree.map(jnp.asarray, pred),
                                  jnp.asarray(x), jnp.asarray(policy),
                                  num_heads=HEADS)
    got = tdyn.predictor_forward(predictor_from_jax(pred, "cpu", HEADS),
                                 _t(x), _t(policy))
    assert _rel_err(got.detach().numpy(), want) < 1e-5


def _jax_uniforms(keys, l_pad):
    return np.stack([np.asarray(jax.random.uniform(k, (l_pad, 2)))
                     for k in keys])


def test_dynamic_batch_loss_and_predictor_gradients_match_jax(model,
                                                              batches):
    """Per-sample loss, ce, mask_loss and keep_ratio within 1e-5 of the
    reference's ``dynamic_train_forward`` (the keep decisions equal), and
    the predictor's gradients of the batch mean within 1e-4 of each
    tensor's max |value| against ``jax.grad``; the model's parameters get
    none."""
    jcfg, jparams, tree, pred = model
    jb, tb = batches
    tau = 0.6
    jsched = jdt.DynamicScheduleConfig(budget=BUDGET)
    keys = [jax.random.PRNGKey(10 + i) for i in range(2)]

    def jloss(pp):
        outs = [jdt.dynamic_train_forward(
            pp, jparams, jax.tree.map(lambda x: x[i], jb), jcfg,
            jnp.asarray(tau), keys[i], jsched) for i in range(2)]
        return (sum(o[0] for o in outs) / 2,
                [dict(o[1], loss=o[0]) for o in outs])

    (_, jm), want = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, pred))
    params, predictor = _port(tree, pred)
    sched = tdt.DynamicScheduleConfig(budget=BUDGET)
    state = tdt.init_dynamic_train_state(params, predictor, sched)
    uniforms = _t(_jax_uniforms(keys, tb.image_positions.shape[1]))
    losses, metrics = tdt.dynamic_batch_forward(
        state.predictor, params, tb, four_layers(qwen25vl_tiny()), tau,
        sched, uniforms)
    losses.mean().backward()
    for i in range(2):
        np.testing.assert_allclose(float(losses[i].detach()),
                                   float(jm[i]["loss"]),
                                   atol=1e-5, rtol=0)
        for k in ("ce", "mask_loss", "keep_ratio"):
            np.testing.assert_allclose(float(metrics[k][i]),
                                       float(jm[i][k]), atol=1e-5, rtol=0)
    assert 0 < float(metrics["keep_ratio"].min()) < 1
    flat = {"blocks." + k: v for k, v in want["blocks"].items()}
    flat.update({k: v for k, v in want.items() if k != "blocks"})
    for name, p in predictor.named_parameters():
        if name.startswith("blocks."):
            _, i, leaf = name.split(".")
            ref = np.asarray(flat["blocks." + leaf])[int(i)]
        else:
            ref = flat[name]
        assert _rel_err(p.grad.numpy(), ref) < 1e-4, name
    assert all(p.grad is None for p in params.parameters())


@pytest.mark.parametrize("async_save", [False, True])
def test_dynamic_resume_equals_uninterrupted(model, batches, tmp_path,
                                             async_save):
    """Three steps straight, against two steps, a checkpoint (written by
    the background writer or in the foreground), a restore into a fresh
    state and a third step: the predictor, the step and the generator's
    state (so the third step's Gumbel draws) equal bit for bit."""
    _, _, tree, pred = model
    _, tb = batches
    cfg = four_layers(qwen25vl_tiny())
    sched = tdt.DynamicScheduleConfig(total_steps=3, lr=5e-3, budget=BUDGET)

    def fresh():
        params, predictor = _port(tree, pred)
        return params, tdt.init_dynamic_train_state(params, predictor, sched,
                                                    seed=3)

    params, state = fresh()
    for _ in range(3):
        state, m = tdt.dynamic_train_step(state, params, tb, cfg, sched)
    assert m["tau"] < 1.0
    straight = {k: v.detach().clone() for k, v in state.trainable().items()}
    params, state = fresh()
    saver = tckpt.AsyncSaver() if async_save else None
    for _ in range(2):
        state, _ = tdt.dynamic_train_step(state, params, tb, cfg, sched)
    tckpt.save_train_state(state, str(tmp_path), saver=saver)
    if saver is not None:
        saver.finalize_saves()
    params, state2 = fresh()
    state2, resumed = tckpt.maybe_resume(str(tmp_path), state2)
    assert resumed and state2.step == 2
    assert torch.equal(state2.generator.get_state(),
                       state.generator.get_state())
    state2, _ = tdt.dynamic_train_step(state2, params, tb, cfg, sched)
    for name, p in state2.trainable().items():
        assert torch.equal(p.detach(), straight[name]), name


def test_predictor_export_round_trip(model, tmp_path):
    """``export_predictor_to_safetensors`` writes the reference's flat
    names and shapes (its ``export_predictor_to_safetensors``, blocks
    stacked) and ``load_predictor`` reads it back bit for bit."""
    _, _, _, pred = model
    predictor = predictor_from_jax(pred, "cpu", HEADS)
    path = str(tmp_path / "image_score_predictor.safetensors")
    tdt.export_predictor_to_safetensors(predictor, path)
    got = tdt.load_predictor(path, "cpu", HEADS)
    for (n, a), (_, b) in zip(predictor.named_parameters(),
                              got.named_parameters()):
        assert torch.equal(a, b), n
    pytest.importorskip("safetensors")
    from safetensors.numpy import load_file

    ref = str(tmp_path / "ref.safetensors")
    jdt.export_predictor_to_safetensors(pred, ref)
    want = {k: v.shape for k, v in load_file(ref).items()}
    assert {k: tuple(v.shape) for k, v in tdt.predictor_tensors(
        predictor).items()} == want
    assert os.path.getsize(path) > 0
