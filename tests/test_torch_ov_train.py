"""The port's LLaVA-OneVision-1.5 selector training against the JAX
package's on llava_ov_tiny (2 decoder layers, vision bucket 16, text
bucket 64): the sample builders field for field, one sample's composite
loss, the scorer gradients of ``batch_loss`` against ``jax.grad``, three
optimizer steps against optax, gradient accumulation and remat, the
uncompressed logits, the fp32 LM head (tied and untied), and
``api.train --family llava_ov15 --smoke``.

Weights come from ``jax_ov_param_tree`` (numpy, the scorer at std 0.02 as
``test_torch_train.py``'s); fp32 throughout. Tolerances, each stated where
it is used: fp32 sum-order differences relative to each tensor's largest
|value|, or absolute where the values are O(1).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ov_params import one_thread, ov_tree  # noqa: F401 (autouse)
from torch_port_params import jax_ov_param_tree

from visionselector_tpu.core.config import llava_ov_tiny as jax_ov_tiny
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu.train import data as jdata
from visionselector_tpu.train import loss as jloss
from visionselector_tpu.train import ov_loss as jov
from visionselector_tpu.train import train_step as jstep
from visionselector_tpu_torch.core.config import llava_ov_tiny
from visionselector_tpu_torch.kernels.attention import FLASH_BLOCK
from visionselector_tpu_torch.models.llava_ov15.weights import (
    ov_from_jax_params,
)
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.train import data as tdata
from visionselector_tpu_torch.train import loss as tloss
from visionselector_tpu_torch.train import ov_loss as tov
from visionselector_tpu_torch.train import train_step as tstep

S_BUCKET, T_BUCKET, BUDGET = 64, 64, 0.5
IMAGE_HW = (112, 112)  # 64 patches, 16 merged tokens
K_MAX = max(1, int(S_BUCKET // 4 * BUDGET))
# q_bias shifts every score alike: its gradient is zero (see
# test_torch_train.py's ZERO_GRAD)
ZERO_GRAD = "q_bias"


def _rel_err(got, want):
    """max |got - want| over the largest |want|."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def model():
    tree = ov_tree()
    return jax.tree.map(jnp.asarray, tree), tree


def _port_params(tree):
    return ov_from_jax_params(tree, llava_ov_tiny(), "cpu")


def _images(b, seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*IMAGE_HW, 3) * 255).astype(np.uint8)
            for _ in range(b)]


def _kw(i):
    return dict(prompt_before=[101, 102], prompt_after=[103],
                answer_ids=[201 + i, 202, 203, 204][: 3 + i % 2],
                budget=BUDGET, s_bucket=S_BUCKET, t_bucket=T_BUCKET)


def _batches(b=2, seed=0):
    """(JAX batch, port batch) of ``b`` samples from the same images and
    ids."""
    js, ts = [], []
    for i, img in enumerate(_images(b, seed)):
        js.append(jov.build_ov_train_sample(jax_ov_tiny(), img, **_kw(i)))
        ts.append(tov.build_ov_train_sample(llava_ov_tiny(), img, **_kw(i)))
    return (jax.tree.map(jnp.asarray, jdata.stack_samples(js)),
            tloss.to_device(tdata.stack_samples(ts), "cpu"))


@pytest.fixture(scope="module")
def batches():
    return _batches(2)


def _check_fields(got, want):
    """Every reference field equal; RICE's maps equal up to the
    reference's S' (bucket + 4 CLS slots), then rows of segment 0 to the
    kernel's 64-row tile."""
    sp = S_BUCKET + 4  # cls_slots = max(len(grid), 4)
    for f in want._fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if f in ("insert_map", "vit_seg_ids"):
            assert len(w) == sp and len(g) % FLASH_BLOCK == 0, f
            np.testing.assert_array_equal(g[:sp], w, err_msg=f)
            assert (g[sp:] == (S_BUCKET + 1 if f == "insert_map" else 0)
                    ).all(), f
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
    pos = np.asarray(got.position_ids)
    assert (pos == pos[0]).all()  # 1-D rope: the three axes equal
    assert got.kv_bounds.shape == (len(got.vit_seg_ids) // FLASH_BLOCK, 2)


def test_ov_sample_builders_match_jax_field_for_field():
    """``build_ov_train_sample`` and ``build_ov_sample_from_record``
    against the reference's; where the reference asserts, the port raises
    ValueError."""
    img = _images(1, 3)[0]
    _check_fields(tov.build_ov_train_sample(llava_ov_tiny(), img, **_kw(1)),
                  jov.build_ov_train_sample(jax_ov_tiny(), img, **_kw(1)))
    rec = {"ids": [11, 12, 13, 14, 15, 16], "image": img, "image_slot": 2,
           "labels": [-100, -100, -100, -100, 15, 16]}
    kw = dict(budget=BUDGET, s_bucket=S_BUCKET, t_bucket=T_BUCKET,
              min_pixels=1, max_pixels=10**9)
    got = tov.build_ov_sample_from_record(llava_ov_tiny(), rec, **kw)
    _check_fields(got, jov.build_ov_sample_from_record(jax_ov_tiny(), rec,
                                                       **kw))
    assert (got.labels != -100).sum() == 2 and int(got.num_merged) == 16
    with pytest.raises(ValueError, match="text-only"):
        tov.build_ov_sample_from_record(llava_ov_tiny(),
                                        dict(rec, image=None), **kw)
    with pytest.raises(ValueError, match="text bucket"):
        tov.build_ov_sample_from_record(llava_ov_tiny(), rec,
                                        **dict(kw, t_bucket=8))
    with pytest.raises(ValueError, match="text bucket"):
        tov.build_ov_train_sample(llava_ov_tiny(), img,
                                  **dict(_kw(0), t_bucket=8))


def test_ov_train_forward_matches_jax(model, batches):
    """One sample's loss, ce, bce and soft_mass within 1e-5 of JAX."""
    jparams, tree = model
    jb, tb = batches
    params = _port_params(tree)
    fwd = jax.jit(lambda p_, s_: jov.ov_selector_train_forward(
        p_, s_, jax_ov_tiny(), jnp.asarray(0.7), K_MAX))
    for i in range(2):
        js = jax.tree.map(lambda x: x[i], jb)
        ts = tov.OVTrainSample(*(
            np.asarray(x)[i] if f in tov.HOST_FIELDS else x[i]
            for f, x in tb._asdict().items()))
        jl, jm = fwd(jparams, js)
        tl, tm = tov.ov_selector_train_forward(params, ts, llava_ov_tiny(),
                                               0.7, K_MAX)
        assert tl.grad_fn is None  # nothing requires grad here
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=0)
        for key in ("ce", "bce", "soft_mass"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       atol=1e-5, rtol=0)


def test_ov_forward_logits_match_jax(model, batches):
    """The uncompressed logits [T_pad, V] on the sample's real rows within
    1e-4 of JAX's (fp32 logits of O(1))."""
    jparams, tree = model
    jb, tb = batches
    js = jax.tree.map(lambda x: x[0], jb)
    ts = tov.OVTrainSample(*(np.asarray(x)[0] if f in tov.HOST_FIELDS
                             else x[0] for f, x in tb._asdict().items()))
    want = np.asarray(jax.jit(lambda p_, s_: jov.ov_forward_logits(
        p_, s_, jax_ov_tiny()))(jparams, js))
    got = tov.ov_forward_logits(_port_params(tree), ts, llava_ov_tiny())
    n = int(np.asarray(js.seg_ids).sum())
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got[:n].numpy(), want[:n], atol=1e-4, rtol=0)


def test_ov_scorer_gradients_match_jax_grad(model, batches):
    """Scorer gradients of ``batch_loss`` (the OV branch) within 1e-4 of
    each tensor's max |value| against ``jax.grad`` (``ZERO_GRAD`` within
    1e-6 of the largest gradient on both sides); the frozen parameters get
    none."""
    jparams, tree = model
    jb, tb = batches
    want = jax.jit(jax.grad(lambda sp, fp, b_: jstep.batch_loss(
        sp, fp, b_, jax_ov_tiny(), jnp.asarray(1.3), K_MAX)[0]))(
        jparams["scorer"], jparams, jb)
    params = _port_params(tree)
    tstep.init_train_state(params, tstep.ScheduleConfig())
    loss, _ = tstep.batch_loss(params, tb, llava_ov_tiny(), 1.3, K_MAX)
    loss.backward()
    top = max(float(np.abs(want[n]).max()) for n in want)
    for name, p in params.scorer.named_parameters():
        if name == ZERO_GRAD:
            assert np.abs(want[name]).max() < 1e-6 * top
            assert p.grad.abs().max() < 1e-6 * top
        else:
            assert _rel_err(p.grad.numpy(), want[name]) < 1e-4, name
    assert all(p.grad is None for n, p in params.named_parameters()
               if not n.startswith("scorer."))


def _port_steps(tree, tb, sched, n=3):
    """``n`` port steps: per step (metrics, the scorer's gradients before
    the step at its reg_weight, the scorer before, the scorer after)."""
    params = _port_params(tree)
    state = tstep.init_train_state(params, sched)
    out = []

    def scorer():
        return {k: v.detach().clone()
                for k, v in params.scorer.named_parameters()}

    for _ in range(n):
        rw = tloss.reg_weight_schedule(state.step, sched.total_steps,
                                       sched.reg_weight_start,
                                       sched.reg_weight_end)
        loss, _ = tstep.batch_loss(params, tb, llava_ov_tiny(), rw, K_MAX)
        grads = torch.autograd.grad(loss, list(params.scorer.parameters()))
        grads = {k: g.numpy() for (k, _), g in
                 zip(params.scorer.named_parameters(), grads)}
        before = scorer()
        state, m = tstep.train_step(state, params, tb, llava_ov_tiny(),
                                    K_MAX, sched)
        out.append(({k: float(v) for k, v in m.items()}, grads, before,
                    scorer()))
    return out


def test_ov_three_steps_match_optax(model, batches):
    """Three steps of the OV recipe's curriculum (reg_weight 0.1 -> 3.0)
    against the reference's optimizer (optax's clip + adamw from
    ``make_optimizer``) and its ``train_step``:

    - each step's update equals optax's update of the port's own
      gradients from the same parameters, within 1e-4 of the update's max
      |value|, ``ZERO_GRAD`` aside (optax computes Adam's bias correction
      1 - 0.999^t in fp32, 1.5e-5 relative off at t = 2; torch in fp64);
    - loss / ce / bce / grad_norm within 1e-5 relative of the reference's
      ``train_step`` run from the same parameters, reg_weight equal to its
      schedule (within an ulp of its jitted step's), lr
      within 1e-6 relative of optax's schedule; the first step has lr 0
      and moves nothing; the clip threshold sits between the first and
      the last step's norm, so clipping engages later only.

    The updates are held to optax on the port's gradients, and not to the
    reference's whole step: Adam divides each element by its own
    gradient's magnitude, so an element whose gradient is near Adam's eps
    (1e-8; this model has elements at 6e-9) turns the gradients' 1e-5
    relative sum-order differences into a 1e-3 change of its update.
    ``test_ov_scorer_gradients_match_jax_grad`` holds the gradients."""
    jparams, tree = model
    jb, tb = batches
    rw = dict(reg_weight_start=0.1, reg_weight_end=3.0)
    free = tstep.ScheduleConfig(total_steps=3, lr=5e-3, max_grad_norm=0.0,
                                **rw)
    norms = [m["grad_norm"] for m, *_ in _port_steps(tree, tb, free)]
    assert norms[0] < norms[-1], norms  # reg_weight grows 0.1 -> 2.03
    clip = (norms[0] + norms[-1]) / 2
    sched = tstep.ScheduleConfig(total_steps=3, lr=5e-3, max_grad_norm=clip,
                                 **rw)
    jsched = jstep.ScheduleConfig(total_steps=3, lr=5e-3, max_grad_norm=clip,
                                  **rw)
    port = _port_steps(tree, tb, sched)
    lr_fn = jstep.optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=5e-3, warmup_steps=1, decay_steps=3)
    opt = jstep.make_optimizer(jsched)
    opt_state = opt.init(jparams["scorer"])
    state = jstep.init_train_state(jparams, jsched)
    clipped = []
    for i, (m, grads, before, after) in enumerate(port):
        state, jm = jstep.train_step(state, jparams, jb, jax_ov_tiny(),
                                     K_MAX, jsched)
        # the schedule equals the reference's; its jitted step fuses
        # start + (end - start) * frac into one multiply-add, a rounding
        # that can differ by 1 fp32 ulp
        assert m["reg_weight"] == float(jloss.reg_weight_schedule(
            jnp.asarray(i), 3, 0.1, 3.0))
        np.testing.assert_allclose(m["reg_weight"], float(jm["reg_weight"]),
                                   rtol=2**-23, atol=0)
        np.testing.assert_allclose(m["lr"], float(lr_fn(i)), rtol=1e-6)
        for key in ("loss", "grad_norm", "ce", "bce"):
            np.testing.assert_allclose(m[key], float(jm[key]), rtol=1e-5)
        updates, opt_state = opt.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, opt_state,
            {k: jnp.asarray(v.numpy()) for k, v in before.items()})
        for name, u in updates.items():
            got = (after[name] - before[name]).numpy()
            if i == 0:
                assert m["lr"] == 0.0 and not got.any()
            elif name != ZERO_GRAD:
                assert _rel_err(got, np.asarray(u)) < 1e-4, (i, name)
        clipped.append(m["grad_norm"] >= clip)
    assert clipped[0] is False and any(clipped), clipped


def test_ov_accum_equals_big_batch_and_remat_is_exact(model):
    """``train_step_accum`` over two OV micro-batches of one sample equals
    ``train_step`` on the batch of two (scorer within 1e-6 of its max
    |value|, same loss); ``remat=True`` gives bit-equal gradients."""
    _, tree = model
    _, tb = _batches(2, seed=1)
    sched = tstep.ScheduleConfig(total_steps=4, lr=5e-3)
    micro = [tov.OVTrainSample(*(
        np.asarray(x)[i:i + 1] if f in tov.HOST_FIELDS else x[i:i + 1]
        for f, x in tb._asdict().items())) for i in range(2)]
    results = []
    for accum in (False, True):
        params = _port_params(tree)
        state = tstep.init_train_state(params, sched)
        for _ in range(2):
            if accum:
                state, m = tstep.train_step_accum(
                    state, params, micro, llava_ov_tiny(), K_MAX, sched)
            else:
                state, m = tstep.train_step(state, params, tb,
                                            llava_ov_tiny(), K_MAX, sched)
        results.append((float(m["loss"]), params.scorer))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-6)
    for (n, a), (_, b) in zip(results[0][1].named_parameters(),
                              results[1][1].named_parameters()):
        assert _rel_err(b.detach().numpy(), a.detach().numpy()) < 1e-6, n
    grads = []
    for remat in (False, True):
        params = _port_params(tree)
        tstep.init_train_state(params, sched)
        loss, _ = tstep.batch_loss(params, tb, llava_ov_tiny(), 1.0, K_MAX,
                                   remat=remat)
        loss.backward()
        grads.append([p.grad for p in params.scorer.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("tied", [True, False])
def test_lm_head_matches_jax_on_the_cpu(tied):
    """The head keeps the upcast on CPU tensors: bf16 hidden and weights,
    fp32 logits within 1e-5 relative (1e-6 absolute) of JAX's
    ``lm_head``, tied and untied."""
    jcfg = jax_ov_tiny()
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(
        jcfg.text, tie_word_embeddings=tied))
    tree = jax_ov_param_tree(jcfg, seed=2)
    tcfg = llava_ov_tiny()
    tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(
        tcfg.text, tie_word_embeddings=tied))
    lm = ov_from_jax_params(tree, tcfg, "cpu", torch.bfloat16).lm
    h = torch.from_numpy(np.random.RandomState(6).randn(5, 96).astype(
        np.float32)).bfloat16()
    got = tlm.lm_head(lm, h)
    jp = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
          for k, v in (("embed_tokens", lm.embed_tokens),
                       ("lm_head_kernel", getattr(lm, "lm_head_kernel",
                                                  lm.embed_tokens)))}
    want = jlm.lm_head(jp, jnp.asarray(h.float().numpy(), jnp.bfloat16),
                       jcfg.text)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_train_cli_ov_smoke_writes_log_checkpoint_and_scorer(tmp_path):
    """``api.train --family llava_ov15 --smoke --device cpu``: three log
    lines, checkpoint-3, and a scorer under ``model.visual.`` that
    ``load_ov_checkpoint`` reads from an OV HF directory it is copied
    into, moved by training from the smoke model's initial scorer."""
    import shutil

    from visionselector_tpu_torch.api import train as tapi
    from visionselector_tpu_torch.models.llava_ov15.model import (
        init_ov_params,
    )
    from visionselector_tpu_torch.models.llava_ov15.weights import (
        load_ov_checkpoint,
        save_ov_checkpoint,
    )

    out = str(tmp_path / "smoke")
    assert tapi.main(["--family", "llava_ov15", "--smoke", "--device", "cpu",
                      "--total-steps", "3", "--batch-size", "2",
                      "--log-steps", "1", "--reg-weight-end", "3.0",
                      "--output-dir", out]) == 0
    with open(os.path.join(out, "train_log.jsonl")) as f:
        log = [json.loads(ln) for ln in f]
    assert [m["step"] for m in log] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) for m in log)
    assert os.path.isdir(os.path.join(out, "checkpoint-3"))
    cfg = llava_ov_tiny()
    init = init_ov_params(cfg, torch.Generator().manual_seed(42), "cpu")
    hf = str(tmp_path / "hf")
    scorer, init.scorer = init.scorer, None
    save_ov_checkpoint(init, cfg, hf)
    shutil.copy(os.path.join(out, "importance_scorer.safetensors"), hf)
    loaded = load_ov_checkpoint(hf, cfg, "cpu")
    assert loaded.scorer is not None
    moved = [not torch.equal(a, b) for a, b in zip(
        loaded.scorer.parameters(), scorer.parameters())]
    assert any(moved)
