"""The port's GRPO (``--method grpo``) against the JAX package's on the
tiny configs with 4 decoder layers: ``expand_vision_tokens_at_slots``,
``group_advantages``, the rewards, ``per_token_logps`` at temperature 1
and 0.7 (both families), the step-0 loss and metrics against the
reference's ``grpo_train_step``, three ``grpo_train_step``s against optax
for each loss type, with beta 0 and with LoRA (KL exactly 0 at step 0,
the reference unchanged), accumulation, the sample builders field for
field, and ``rollout_group``: greedy rollouts with live adapters token
for token against the JAX engine's, sampled ones reproduced by their
seeds.

Weights come from ``jax_param_tree`` / ``ov_tree`` (numpy), fp32. The
tolerances are stated where used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sft import _with_jax_adapters, nested
from torch_ov_params import one_thread, ov_tree  # noqa: F401 (autouse)
from torch_port_params import jax_param_tree
from torch_serving_params import serving_tree

from visionselector_tpu.core.config import llava_ov_tiny as jax_ov_tiny
from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.preprocess import rope as jrope
from visionselector_tpu.train import grpo as jgrpo
from visionselector_tpu.train import sft as jsft
from visionselector_tpu_torch.core.config import llava_ov_tiny, qwen25vl_tiny
from visionselector_tpu_torch.kernels.attention import FLASH_BLOCK
from visionselector_tpu_torch.models.llava_ov15.weights import (
    ov_from_jax_params,
)
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.preprocess import rope as trope
from visionselector_tpu_torch.preprocess.image import preprocess_image
from visionselector_tpu_torch.train import dpo as tdpo
from visionselector_tpu_torch.train import grpo as tgrpo
from visionselector_tpu_torch.train import lora as tlora
from visionselector_tpu_torch.train import loss as tloss

S_BUCKET, T_BUCKET = 128, 64
RANK, ALPHA = 4, 8
# one group of G = 2 completions (the steps' batch), and two of 2 (the
# accumulation test)
COMPLETIONS = [[201, 202], [207, 208, 209, 210, 211]]
REWARDS = [1.0, 0.0]
GROUPS = [[201, 202], [203, 204, 205], [206], [207, 208, 209, 210, 211]]
GROUP_REWARDS = [1.0, 0.0, 0.5, 0.0]
KW = dict(budget=0.25, s_bucket=S_BUCKET, t_bucket=T_BUCKET, min_pixels=1,
          max_pixels=10**9)


def four_layers(cfg):
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=4))


def _img(seed, hw=(56, 84)):
    return (np.random.RandomState(seed).rand(*hw, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree():
    return jax_param_tree(four_layers(jax_tiny()), seed=5, scorer_std=0.02)


def _port(tree):
    return from_jax_params(tree, four_layers(qwen25vl_tiny()), "cpu")


def _batch(family="qwen", seed=0, completions=COMPLETIONS):
    """(JAX batch, port batch) of one prompt's completions
    (``build_grpo_batch``; the Qwen port on the classic layout)."""
    img = _img(seed)
    if family == "qwen":
        jcfg, tcfg, extra = jax_tiny(), qwen25vl_tiny(), dict(
            align_windows=False)
    else:
        jcfg, tcfg, extra = jax_ov_tiny(), llava_ov_tiny(), {}
    fam = "qwen25vl" if family == "qwen" else "llava_ov15"
    j = jgrpo.build_grpo_batch(jcfg, img, [101, 102], [103], completions,
                               family=fam, **KW)
    t = tgrpo.build_grpo_batch(tcfg, img, [101, 102], [103], completions,
                               family=fam, **KW, **extra)
    return jax.tree.map(jnp.asarray, j), tloss.to_device(t, "cpu"), j, t


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.mark.parametrize("ids, slots, grids", [
    ([1, 2, 3, 4], [2], [(1, 4, 6)]),
    ([1, 2, 3, 4, 5], [0, 3], [(1, 2, 2), (1, 4, 2)]),
    ([1, 2], [2, 2], [(1, 2, 4), (2, 2, 2)]),
    ([7], [0], [(1, 6, 6)]),
])
def test_expand_vision_tokens_at_slots_matches_jax(ids, slots, grids):
    """The spliced ids equal the reference's; a slot count other than the
    grid rows, or slots out of order, raise ValueError (the reference
    asserts)."""
    got = trope.expand_vision_tokens_at_slots(ids, slots, np.array(grids))
    want = jrope.expand_vision_tokens_at_slots(ids, slots, np.array(grids))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    with pytest.raises(ValueError, match="grid rows"):
        trope.expand_vision_tokens_at_slots(ids, slots + [len(ids)],
                                            np.array(grids))
    if slots[::-1] != sorted(slots):
        with pytest.raises(ValueError, match="ascend"):
            trope.expand_vision_tokens_at_slots(ids, slots[::-1],
                                                np.array(grids))


@pytest.mark.parametrize("rewards, g, scale", [
    ([1.0, 0.0, 0.5, 0.0, 2.0, 2.0, 1.0, 3.0], 4, True),
    ([1.0, 0.0, 0.5, 0.0, 2.0, 2.0], 2, False),
    ([0.5, 0.5, 0.5], 3, True),  # a constant group: finite, zero
])
def test_group_advantages_match_jax(rewards, g, scale):
    """Exactly the reference's advantages (unbiased std + 1e-4); one
    generation raises ValueError, as the reference's does."""
    got = tgrpo.group_advantages(np.array(rewards), g, scale)
    np.testing.assert_array_equal(
        got, jgrpo.group_advantages(np.array(rewards), g, scale))
    with pytest.raises(ValueError, match="num_generations"):
        tgrpo.group_advantages(np.array(rewards), 1)


def test_rewards_match_jax():
    """``accuracy_reward`` and ``format_reward`` equal the reference's on
    tagged, numeric, untagged and malformed completions."""
    comps = ["<think>x</think><answer>42</answer>", "<answer> 42.0 </answer>",
             "42", "<think>a</think>\n<answer>b</answer> tail",
             "<answer>7</answer>", "no tags", " <think>x</think><answer>42"
             "</answer>", "<answer>abc</answer>"]
    sols = ["<answer>42</answer>", "42", "42", "b", "8", "no tags", "42",
            "abc"]
    assert tgrpo.accuracy_reward(comps, sols) == jgrpo.accuracy_reward(
        comps, sols)
    assert tgrpo.format_reward(comps) == jgrpo.format_reward(comps)
    assert set(tgrpo.REWARD_FUNCS) == set(jgrpo.REWARD_FUNCS)


@pytest.mark.parametrize("family, temperature", [
    ("qwen", 1.0), ("qwen", 0.7), ("ov", 0.7)])
def test_per_token_logps_match_jax(tree, family, temperature):
    """Each completion's per-token log-probs (the logits over the
    temperature) within 1e-4 of the reference's (values O(1-10)), zero off
    the completion; the masks equal."""
    jb, tb, _, _ = _batch(family)
    if family == "qwen":
        jcfg, tcfg = four_layers(jax_tiny()), four_layers(qwen25vl_tiny())
        jtree, params = tree, _port(tree)
    else:
        jcfg, tcfg = four_layers(jax_ov_tiny()), four_layers(llava_ov_tiny())
        jtree = ov_tree(layers=4)
        params = ov_from_jax_params(jtree, tcfg, "cpu")
    jp = jax.tree.map(jnp.asarray, jtree)
    wlp, wmask = jax.jit(jax.vmap(lambda s: jgrpo.per_token_logps(
        jp, s, jcfg, temperature=temperature)))(jb)
    with torch.no_grad():
        lp, mask = tdpo.token_logps(params, tb, temperature=temperature)
        one = tgrpo.per_token_logps(params, type(tb)(*(
            np.asarray(x)[1] if f in type(tb).host_fields else x[1]
            for f, x in tb._asdict().items())), tcfg,
            temperature=temperature)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(lp.numpy(), np.asarray(wlp), atol=1e-4,
                               rtol=0)
    assert not lp[~mask].any()
    assert torch.equal(one[1], mask[1])
    np.testing.assert_allclose(one[0].numpy(), lp[1].numpy(), atol=1e-5)


SCHEDS = {
    "grpo": dict(),
    "bnpo": dict(loss_type="bnpo"),
    "dr_grpo": dict(loss_type="dr_grpo", max_completion_length=6),
    "beta0": dict(beta=0.0),
    "lora": dict(lora_rank=RANK),
}


def _rel_err(got, want):
    """max |got - want| over the largest |want| (fp32: the arrays are fp32
    and the limits 1e-4 and above)."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _values(state):
    return {k: v.detach().clone() for k, v in state.trainables.items()}


@pytest.mark.parametrize("kind", list(SCHEDS))
def test_grpo_three_steps_match_optax(tree, batch, kind):
    """Three ``grpo_train_step``s (one prompt, G = 2, lr 5e-3, no clip)
    from the same weights: at step 0 the KL is exactly 0 (policy ==
    reference, bit for bit) and clip_ratio 0; each update equals optax's
    on the port's own gradients within 1e-4 of its max |value| (lr 0 at
    the first; LoRA's A, whose gradient is 0 while B is 0, moves only at
    the third step); the KL is positive once the policy moved; the
    reference unchanged (its copy, or the base with the adapters off).
    Beta 0 logs no KL and takes no reference."""
    _, tb, _, _ = batch
    cfg = four_layers(qwen25vl_tiny())
    common = dict(total_steps=3, lr=5e-3, max_grad_norm=0.0,
                  num_generations=2, **SCHEDS[kind])
    sched = tgrpo.GRPOScheduleConfig(**common)
    jsched = jgrpo.GRPOScheduleConfig(**common)
    adv = torch.from_numpy(tgrpo.group_advantages(np.array(REWARDS), 2))
    params = _port(tree)
    if kind == "lora":
        tlora.add_lora_params(params.lm, torch.Generator().manual_seed(0),
                              rank=RANK, alpha=ALPHA)
    state = tgrpo.init_grpo_state(params, sched)
    ref = tdpo.ReferencePolicy(params, state) if sched.beta > 0 else None
    start = _values(state)
    names = [n for n, _ in params.named_parameters()]
    ptree = nested({n: jnp.asarray(p.detach().numpy())
                    for n, p in params.named_parameters()})
    opt = jsft.make_optimizer(ptree, jsched.sft_view())
    opt_state = opt.init(ptree)
    update = jax.jit(opt.update)
    kls = []
    for i in range(3):
        before = _values(state)
        state, m = tgrpo.grpo_train_step(state, ref, params, tb, adv, cfg,
                                         sched)
        # the update's gradient, left in .grad (no clip)
        grads = {n: p.grad.numpy() for n, p in state.trainables.items()}
        assert ("kl" in m) == (sched.beta > 0)
        kls.append(float(m.get("kl", 0.0)))
        if i == 0:
            assert kls[0] == 0.0 and float(m["clip_ratio"]) == 0.0
            assert float(m["completion_tokens"]) == np.mean(
                [len(c) for c in COMPLETIONS])
        after = _values(state)
        full = {n: jnp.asarray(grads[n] if n in grads else np.zeros(
            ptree[n.split(".", 1)[0]][n.split(".", 1)[1]].shape, np.float32))
            for n in names}
        updates, opt_state = update(nested(full), opt_state, ptree)
        ptree = nested({n: jnp.asarray(after[n].numpy()) if n in after
                        else ptree[n.split(".", 1)[0]][n.split(".", 1)[1]]
                        for n in names})
        for name in grads:
            u = np.asarray(updates[name.split(".", 1)[0]][
                name.split(".", 1)[1]])
            got = (after[name] - before[name]).numpy()
            if i == 0 or (kind == "lora" and i == 1 and "_lora_a" in name):
                assert not got.any(), (i, name)
            else:
                assert _rel_err(got, u) < 1e-4, (i, name)
    if sched.beta > 0:
        assert kls[2] > 0.0, kls
    if kind == "lora":
        fresh = _port(tree)
        with ref.active():
            got = tdpo.token_logps(params, tb)[0]
        with torch.no_grad():
            want = tdpo.token_logps(fresh, tb)[0]
        assert torch.equal(got, want)
    elif ref is not None:
        assert all(torch.equal(ref.weights[n], start[n]) for n in start)


def test_grpo_step_zero_matches_jax_step(tree, batch):
    """Step 0 of the reference's jitted ``grpo_train_step`` (its own
    vmapped forward, beta 0.04, the decoder trained) on the same batch and
    advantages: the loss within 1e-6, KL 0 in both, clip_ratio and
    completion_tokens equal."""
    jb, tb, _, _ = batch
    cfg = four_layers(qwen25vl_tiny())
    common = dict(total_steps=3, lr=5e-3, num_generations=2)
    adv = tgrpo.group_advantages(np.array(REWARDS), 2)
    jtree = jax.tree.map(jnp.asarray, tree)
    jsched = jgrpo.GRPOScheduleConfig(**common)
    _, jm = jgrpo.grpo_train_step(jgrpo.init_grpo_state(jtree, jsched),
                                  jtree, jb, jnp.asarray(adv),
                                  four_layers(jax_tiny()), jsched)
    params = _port(tree)
    sched = tgrpo.GRPOScheduleConfig(**common)
    state = tgrpo.init_grpo_state(params, sched)
    ref = tdpo.ReferencePolicy(params, state)
    _, m = tgrpo.grpo_train_step(state, ref, params, tb,
                                 torch.from_numpy(adv), cfg, sched)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=1e-6, rtol=0)
    assert float(m["kl"]) == float(jm["kl"]) == 0.0
    for k in ("clip_ratio", "completion_tokens", "advantage_mean"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-7,
                                   err_msg=k)


def test_grpo_accum_equals_concatenated(tree):
    """``grpo_train_step_accum`` over two prompts' groups (G = 2 each)
    against ``grpo_train_step`` on the concatenated [4] batch: the same
    loss and metrics within 1e-6, the gradient (in ``.grad``, no clip)
    within 1e-5 of each tensor's max |value|."""
    parts = [_batch(seed=s, completions=GROUPS[2 * s:2 * s + 2])[3]
             for s in (0, 1)]
    whole = tloss.to_device(type(parts[0])(*(
        np.concatenate([getattr(p, f) for p in parts])
        for f in type(parts[0])._fields)), "cpu")
    micro = [tloss.to_device(p, "cpu") for p in parts]
    adv = [tgrpo.group_advantages(np.array(GROUP_REWARDS[2 * s:2 * s + 2]),
                                  2) for s in (0, 1)]
    cfg = four_layers(qwen25vl_tiny())
    sched = tgrpo.GRPOScheduleConfig(total_steps=3, lr=5e-3,
                                     max_grad_norm=0.0, num_generations=2)
    results = []
    for accum in (False, True):
        params = _port(tree)
        state = tgrpo.init_grpo_state(params, sched)
        ref = tdpo.ReferencePolicy(params, state)
        if accum:
            state, m = tgrpo.grpo_train_step_accum(
                state, ref, params, micro, [torch.from_numpy(a) for a in adv],
                cfg, sched)
        else:
            state, m = tgrpo.grpo_train_step(
                state, ref, params, whole,
                torch.from_numpy(np.concatenate(adv)), cfg, sched)
        results.append(({k: float(v) for k, v in m.items()},
                        {n: p.grad.clone() for n, p in
                         state.trainables.items()}))
    (m0, g0), (m1, g1) = results
    for k in m0:
        np.testing.assert_allclose(m1[k], m0[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    for n, g in g0.items():
        assert _rel_err(g1[n].numpy(), g.numpy()) < 1e-5, n


@pytest.mark.parametrize("loss_type", ["bnpo", "dr_grpo"])
def test_grpo_accum_rejects_global_token_reductions(loss_type):
    sched = tgrpo.GRPOScheduleConfig(loss_type=loss_type)
    with pytest.raises(ValueError, match="'grpo' only"):
        tgrpo.grpo_train_step_accum(None, None, None, [], [], None, sched)


def _check_fields(got, want, ov: bool):
    """Every reference field equal (the Qwen kv bounds, built at the
    port's tile, skipped; RICE's maps up to the reference's S')."""
    for f in want._fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if f.endswith("kv_bounds"):
            continue
        if ov and f in ("insert_map", "vit_seg_ids"):
            assert g.shape[-1] % FLASH_BLOCK == 0, f
            np.testing.assert_array_equal(g[..., :w.shape[-1]], w, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("case", ["qwen one", "qwen two", "ov", "batch qwen",
                                  "batch ov"])
def test_grpo_builders_match_jax(case):
    """``build_grpo_sample`` (one and two images, OV) and
    ``build_grpo_batch`` against the reference's, field for field; the
    labels supervise exactly the completion. No image, or two under OV,
    raises ValueError (the reference asserts)."""
    ov = "ov" in case
    if case.startswith("batch"):
        _, _, j, t = _batch("ov" if ov else "qwen")
        _check_fields(t, j, ov)
        return
    jcfg, tcfg = ((jax_ov_tiny(), llava_ov_tiny()) if ov
                  else (jax_tiny(), qwen25vl_tiny()))
    fam = "llava_ov15" if ov else "qwen25vl"
    images = [_img(1), _img(2, (84, 56))][:2 if case == "qwen two" else 1]
    prompt = [11, 12, 13, 14, 15, 16]
    slots = [2, 4][:len(images)]
    comp = np.array([301, 302, 303], np.int32)
    kw = dict(KW, t_bucket=128)
    extra = {} if ov else dict(align_windows=False)
    got = tgrpo.build_grpo_sample(tcfg, images, prompt, slots, comp,
                                  family=fam, **kw, **extra)
    want = jgrpo.build_grpo_sample(jcfg, images, prompt, slots, comp,
                                   family=fam, **kw)
    _check_fields(got, want, ov)
    labels = np.asarray(got.labels)
    np.testing.assert_array_equal(labels[labels != -100], comp)
    with pytest.raises(ValueError, match="at least one image"):
        tgrpo.build_grpo_sample(tcfg, [], prompt, [], comp, family=fam, **kw)
    if ov:
        with pytest.raises(ValueError, match="single image"):
            tgrpo.build_grpo_sample(tcfg, images * 2, prompt, [2, 4], comp,
                                    family=fam, **kw)


def test_rollouts_greedy_match_jax_engine_and_seeds_reproduce():
    """``rollout_group`` through ``QwenVLEngine(use_selector=False)`` with
    LoRA adapters live (B random, so they act): at temperature 0 every
    member's 6 tokens equal the reference engine's on the same adapter
    tree; at temperature 1 each member is reproduced by its seed (seed *
    1000003 + g) and the group is not one completion repeated."""
    jcfg, tcfg = four_layers(jax_tiny()), four_layers(qwen25vl_tiny())
    tree = serving_tree(jcfg, seed=2)
    params = from_jax_params(tree, tcfg, "cpu")
    jtree = jax.tree.map(jnp.asarray, _with_jax_adapters(tree, params))
    px, grid = preprocess_image(_img(4), min_pixels=1, max_pixels=10**9)
    ids = trope.expand_vision_tokens_at_slots([5, 6, 7, 8], [2], grid)
    greedy = tgrpo.GRPOScheduleConfig(num_generations=2, temperature=0.0,
                                      max_completion_length=6)
    eng = tmodel.QwenVLEngine(tcfg, params, use_selector=False, device="cpu")
    jeng = jmodel.QwenVLEngine(jcfg, jtree, use_selector=False)
    got = tgrpo.rollout_group(eng, ids, px, grid, greedy, seed=3,
                              eos_token_ids=(-1,))
    want = jgrpo.rollout_group(jeng, ids, px, grid, greedy, seed=3,
                               eos_token_ids=(-1,))
    assert [c.tolist() for c in got] == [w.tolist() for w in want]
    assert len(got[0]) == 6
    sampled = greedy._replace(num_generations=4, temperature=1.0)
    first = tgrpo.rollout_group(eng, ids, px, grid, sampled, seed=9)
    again = tgrpo.rollout_group(eng, ids, px, grid, sampled, seed=9)
    assert [c.tolist() for c in first] == [c.tolist() for c in again]
    for g, c in enumerate(first):
        res = eng.generate(ids, px, grid, max_new_tokens=6, temperature=1.0,
                           seed=9 * 1000003 + g)
        assert res.tokens == c.tolist()
    assert len({tuple(c.tolist()) for c in first}) >= 2
