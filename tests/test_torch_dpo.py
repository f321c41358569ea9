"""The port's DPO (``--method dpo``) against the JAX package's on the tiny
configs with 4 decoder layers: ``dpo_losses`` (sigmoid, IPO, label
smoothing), ``sequence_logps`` of both families, the DPO gradient at the
starting weights against ``jax.grad``, three optimizer steps against optax
for the full decoder and for LoRA, the frozen reference (unchanged, ln 2
at step 0, the starting weights after a resume), accumulation, and
``build_dpo_pair_from_record`` field for field.

Weights come from ``jax_param_tree`` / ``ov_tree`` (numpy), fp32. The
tolerances are stated where used: fp32 sum-order differences relative to
each tensor's largest |value|, or absolute where the values are O(1).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sft import jax_leaf, nested
from torch_ov_params import one_thread, ov_tree  # noqa: F401 (autouse)
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import llava_ov_tiny as jax_ov_tiny
from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.train import data as jdata
from visionselector_tpu.train import dpo as jdpo
from visionselector_tpu.train import ov_loss as jov
from visionselector_tpu.train import sft as jsft
from visionselector_tpu_torch.core import checkpoint as tckpt
from visionselector_tpu_torch.core.config import llava_ov_tiny, qwen25vl_tiny
from visionselector_tpu_torch.kernels.attention import FLASH_BLOCK
from visionselector_tpu_torch.models.llava_ov15.weights import (
    ov_from_jax_params,
)
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.train import data as tdata
from visionselector_tpu_torch.train import dpo as tdpo
from visionselector_tpu_torch.train import lora as tlora
from visionselector_tpu_torch.train import loss as tloss
from visionselector_tpu_torch.train import ov_loss as tov

S_BUCKET, T_BUCKET = 128, 64
RANK, ALPHA = 4, 8
LN2 = float(-torch.nn.functional.logsigmoid(torch.zeros(())))


def four_layers(cfg):
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=4))


class StubTokenizer:
    """One id per character; never an image or vision-marker id."""

    def encode(self, text):
        return [ord(c) % 500 + 10 for c in text]


@pytest.fixture(scope="module")
def tree():
    return jax_param_tree(four_layers(jax_tiny()), seed=5, scorer_std=0.02)


def _port(tree):
    return from_jax_params(tree, four_layers(qwen25vl_tiny()), "cpu")


def _pairs(n=2, seed=0, family="qwen"):
    """n (chosen, rejected) pairs: one image and prompt each, two
    completions. Returns ((JAX chosen, JAX rejected), (port chosen, port
    rejected)), each stacked."""
    rng = np.random.RandomState(seed)
    qwen = family == "qwen"
    jb = jdata.build_train_sample if qwen else jov.build_ov_train_sample
    tb = tdata.build_train_sample if qwen else tov.build_ov_train_sample
    jcfg, tcfg = ((jax_tiny(), qwen25vl_tiny()) if qwen
                  else (jax_ov_tiny(), llava_ov_tiny()))
    out = {k: [] for k in ("jc", "jr", "tc", "tr")}
    for i in range(n):
        img = (rng.rand(56 if i % 2 else 84, 84, 3) * 255).astype(np.uint8)
        kw = dict(budget=0.25, s_bucket=S_BUCKET, t_bucket=T_BUCKET,
                  min_pixels=1, max_pixels=10**9)
        for key, ans in (("c", [201 + i, 202, 203]), ("r", [301, 302 + i])):
            out["j" + key].append(jb(jcfg, img, [101, 102], [103], ans,
                                     **kw))
            out["t" + key].append(tb(tcfg, img, [101, 102], [103], ans,
                                     **kw))
    j = tuple(jax.tree.map(jnp.asarray, jdata.stack_samples(out[k]))
              for k in ("jc", "jr"))
    t = tuple(tloss.to_device(tdata.stack_samples(out[k]), "cpu")
              for k in ("tc", "tr"))
    return j, t


@pytest.fixture(scope="module")
def pairs():
    return _pairs()


@pytest.mark.parametrize("kind", ["sigmoid", "ipo", "smoothing"])
def test_dpo_losses_match_jax(kind):
    """The mean loss and the four reward metrics within 1e-6 of the
    reference's on random [4] log-probs; policy == reference gives ln 2
    and a zero margin under the sigmoid loss."""
    sched = dict(sigmoid=dict(beta=0.1), ipo=dict(beta=0.2, loss_type="ipo"),
                 smoothing=dict(beta=0.5, label_smoothing=0.2))[kind]
    rng = np.random.RandomState(7)
    lps = [(rng.randn(4) * 3 - 10).astype(np.float32) for _ in range(4)]
    lens = [np.array([3, 5, 1, 0]), np.array([2, 2, 4, 7])]
    jl, jm = jdpo.dpo_losses(*map(jnp.asarray, lps), *map(jnp.asarray, lens),
                             jdpo.DPOScheduleConfig(**sched))
    tl, tm = tdpo.dpo_losses(*map(torch.from_numpy, lps),
                             *map(torch.from_numpy, lens),
                             tdpo.DPOScheduleConfig(**sched))
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-6, rtol=0)
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-6,
                                   rtol=0, err_msg=k)
    if kind == "sigmoid":
        pc, pr = torch.from_numpy(lps[0]), torch.from_numpy(lps[1])
        loss, m = tdpo.dpo_losses(pc, pr, pc, pr, *map(torch.from_numpy,
                                                       lens),
                                  tdpo.DPOScheduleConfig(**sched))
        assert float(loss) == LN2 and float(m["reward_margin"]) == 0.0


@pytest.mark.parametrize("family", ["qwen", "ov"])
def test_sequence_logps_match_jax(tree, family):
    """Each sample's (sum of completion log-probs, completion length, CE)
    against the reference's ``sequence_logps``: the sum within 1e-4 of its
    |value|, the length equal, the CE within 1e-5; ``sequence_logps`` of
    one sample within 1e-5 of its row of the batch."""
    (jc, _), (tc, _) = _pairs(2, seed=3, family=family)
    if family == "qwen":
        jcfg, tcfg = four_layers(jax_tiny()), four_layers(qwen25vl_tiny())
        jtree, params = tree, _port(tree)
    else:
        jcfg, tcfg = four_layers(jax_ov_tiny()), four_layers(llava_ov_tiny())
        jtree = ov_tree(layers=4)
        params = ov_from_jax_params(jtree, tcfg, "cpu")
    want = jax.jit(jax.vmap(lambda s: jdpo.sequence_logps(
        jax.tree.map(jnp.asarray, jtree), s, jcfg)))(jc)
    with torch.no_grad():
        got = tdpo.batch_sequence_logps(params, tc)
        one = tdpo.sequence_logps(params, type(tc)(*(
            np.asarray(x)[1] if f in type(tc).host_fields else x[1]
            for f, x in tc._asdict().items())), tcfg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5, rtol=0)
    # one sample alone: a batch of one, other GEMM shapes than the batch's
    np.testing.assert_allclose([float(x) for x in one],
                               [float(x[1]) for x in got], rtol=1e-5)


def _jax_dpo_loss(p, ref, chosen, rejected, jcfg, sched):
    def lp(params, b):
        return jax.vmap(lambda s: jdpo.sequence_logps(params, s, jcfg))(b)

    rc, lc, _ = lp(ref, chosen)
    rr, lr, _ = lp(ref, rejected)
    pc, _, ce = lp(p, chosen)
    pr, _, _ = lp(p, rejected)
    loss, _ = jdpo.dpo_losses(pc, pr, rc, rr, lc, lr, sched)
    return loss + sched.rpo_alpha * ce.mean()


def _rel_err(got, want):
    """max |got - want| over the largest |want| (fp32: the arrays are fp32
    and the limits 1e-4 and above)."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _values(state):
    return {k: v.detach().clone() for k, v in state.trainables.items()}


@pytest.mark.parametrize("kind", ["llm", "lora"])
def test_dpo_three_steps_match_optax(tree, pairs, kind):
    """Three ``dpo_train_step``s from the same weights (the decoder, or
    fresh LoRA adapters; rpo_alpha 0.5): step 0's loss is ln 2 + 0.5 CE
    with a zero margin (policy == reference, bit for bit); its gradient
    within 1e-4 of each leaf's max |value| against ``jax.grad`` of the
    reference's loss; each update equal to optax's on the port's own
    gradients within 1e-4 of its max |value| (lr 0 at the first; LoRA's A,
    whose gradient is 0 while B is 0, moves only at the third step); the
    margin grows; the reference unchanged."""
    (jc, jr), (tc, tr) = pairs
    jcfg, cfg = four_layers(jax_tiny()), four_layers(qwen25vl_tiny())
    lora = dict(lora_rank=RANK) if kind == "lora" else {}
    common = dict(total_steps=3, lr=5e-3, rpo_alpha=0.5, max_grad_norm=0.0,
                  **lora)
    sched = tdpo.DPOScheduleConfig(**common)
    jsched = jdpo.DPOScheduleConfig(**common)
    params = _port(tree)
    if lora:
        tlora.add_lora_params(params.lm, torch.Generator().manual_seed(0),
                              rank=RANK, alpha=ALPHA)
    state = tdpo.init_dpo_state(params, sched)
    ref = tdpo.ReferencePolicy(params, state)
    assert (len(ref.weights) == 0) == bool(lora)
    start = _values(state)
    names = [n for n, _ in params.named_parameters()]
    ptree = nested({n: jnp.asarray(p.detach().numpy())
                    for n, p in params.named_parameters()})
    opt = jsft.make_optimizer(ptree, jsched.sft_view())
    opt_state = opt.init(ptree)
    update = jax.jit(opt.update)
    margins = []
    for i in range(3):
        before = _values(state)
        state, m = tdpo.dpo_train_step(state, ref, params, tc, tr, cfg, sched)
        # the update's gradient, left in .grad (no clip)
        grads = {n: p.grad.numpy() for n, p in state.trainables.items()}
        if i == 0 and not lora:
            jtree = jax.tree.map(jnp.asarray, tree)
            jloss, jgrad = jax.jit(jax.value_and_grad(
                lambda lm: _jax_dpo_loss(dict(jtree, lm=lm), jtree, jc, jr,
                                         jcfg, jsched)))(jtree["lm"])
            jgrad = {"lm": jgrad}
            np.testing.assert_allclose(float(m["loss"]), float(jloss),
                                       atol=1e-5,
                                       rtol=0)
            for name in ("lm.layers.0.q_kernel", "lm.layers.3.down_kernel",
                         "lm.embed_tokens"):
                assert _rel_err(grads[name], jax_leaf(jgrad, name)) < 1e-4
        margins.append(float(m["reward_margin"]))
        if i == 0:
            assert float(m["reward_margin"]) == 0.0
            assert float(m["loss"]) == pytest.approx(
                LN2 + 0.5 * float(m["nll_chosen"]), abs=1e-6)
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
            if i == 0 or (lora and i == 1 and "_lora_a" in name):
                assert not got.any(), (i, name)
            else:
                assert _rel_err(got, u) < 1e-4, (i, name)
    assert margins[0] == 0.0 and margins[-1] > 0.0, margins
    if lora:
        fresh = _port(tree)
        with ref.active(), torch.no_grad():
            got = tdpo.batch_sequence_logps(params, tc)[0]
            want = tdpo.batch_sequence_logps(fresh, tc)[0]
        assert torch.equal(got, want)
        assert all(p.requires_grad for p in state.trainables.values())
    else:
        assert all(torch.equal(ref.weights[n], start[n]) for n in start)
        assert not all(torch.equal(state.trainables[n], start[n])
                       for n in start)


def test_dpo_accum_equals_concatenated(tree):
    """``dpo_train_step_accum`` over two micro pair batches of one pair
    against ``dpo_train_step`` on the batch of two (IPO, the merger
    trained, so the tower runs under grad): the same loss and metrics
    within 1e-6, and the update's gradient (left in ``.grad``, no clip)
    within 1e-5 of each tensor's max |value|. The parameters after Adam's
    first step are not compared: it moves each element by about lr times
    the sign of its gradient, so elements whose gradient is ~0 differ by
    up to 2 lr."""
    _, (tc, tr) = _pairs(2, seed=1)
    cfg = four_layers(qwen25vl_tiny())
    sched = tdpo.DPOScheduleConfig(total_steps=4, lr=5e-3, loss_type="ipo",
                                   max_grad_norm=0.0, tune_mm_mlp=True,
                                   tune_mm_llm=False)

    def part(b, i):
        return type(b)(*(np.asarray(x)[i:i + 1] if f in type(b).host_fields
                         else x[i:i + 1] for f, x in b._asdict().items()))

    results = []
    for accum in (False, True):
        params = _port(tree)
        state = tdpo.init_dpo_state(params, sched)
        ref = tdpo.ReferencePolicy(params, state)
        if accum:
            state, m = tdpo.dpo_train_step_accum(
                state, ref, params, [part(tc, 0), part(tc, 1)],
                [part(tr, 0), part(tr, 1)], cfg, sched)
        else:
            state, m = tdpo.dpo_train_step(state, ref, params, tc, tr, cfg,
                                           sched)
        results.append(({k: float(v) for k, v in m.items()},
                        {n: p.grad.clone() for n, p in
                         state.trainables.items()}))
    (m0, g0), (m1, g1) = results
    for k in m0:
        np.testing.assert_allclose(m1[k], m0[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    for n, g in g0.items():
        assert _rel_err(g1[n].numpy(), g.numpy()) < 1e-5, n


def test_dpo_resume_scores_against_starting_weights(tree, pairs, tmp_path):
    """Full-decoder DPO: three steps straight, against two steps, a
    checkpoint, a fresh model whose reference is taken BEFORE the restore,
    and a third step: the trained tensors bit-equal and the reference
    still the starting weights (a reference taken after the restore would
    be the trained ones)."""
    _, (tc, tr) = pairs
    cfg = four_layers(qwen25vl_tiny())
    sched = tdpo.DPOScheduleConfig(total_steps=3, lr=5e-3)

    def fresh():
        params = _port(tree)
        state = tdpo.init_dpo_state(params, sched)
        return params, state, tdpo.ReferencePolicy(params, state)

    params, state, ref = fresh()
    start = _values(state)
    for _ in range(3):
        state, _ = tdpo.dpo_train_step(state, ref, params, tc, tr, cfg, sched)
    straight = _values(state)
    params, state, ref = fresh()
    for _ in range(2):
        state, _ = tdpo.dpo_train_step(state, ref, params, tc, tr, cfg, sched)
    tckpt.save_train_state(state, str(tmp_path))
    params, state, ref = fresh()
    state, resumed = tckpt.maybe_resume(str(tmp_path), state)
    assert resumed and state.step == 2
    assert all(torch.equal(ref.weights[n], start[n]) for n in start)
    assert not all(torch.equal(state.trainables[n], start[n]) for n in start)
    state, _ = tdpo.dpo_train_step(state, ref, params, tc, tr, cfg, sched)
    for name, p in state.trainables.items():
        assert torch.equal(p.detach(), straight[name]), name


def _check_fields(got, want, ov: bool):
    """Every reference field equal (the Qwen kv bounds, built at the
    port's tile, skipped; RICE's maps up to the reference's S', then
    segment-0 rows to the 64-row tile)."""
    sp = S_BUCKET + 4
    for f in want._fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if f.endswith("kv_bounds"):
            continue
        if ov and f in ("insert_map", "vit_seg_ids"):
            assert len(g) % FLASH_BLOCK == 0, f
            np.testing.assert_array_equal(g[:sp], w, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


RECORDS = {
    "prompt": {"image": "a.png", "prompt": "What is it?",
               "chosen": "A cat.", "rejected": "A dog, surely."},
    "multi-turn": {"image": "a.png", "conversations": [
        {"from": "human", "value": "<image>Describe."},
        {"from": "gpt", "value": "A picture."},
        {"from": "human", "value": "Color?"},
        {"from": "gpt", "value": "old answer"}],
        "chosen": "Red.", "rejected": "It is blue."},
    "two images": {"image": ["a.png", "b.png"],
                   "prompt": "<image>vs<image>: which?",
                   "chosen": "Left.", "rejected": "Right one."},
}


@pytest.mark.parametrize("family, name", [
    ("qwen", "prompt"), ("qwen", "multi-turn"), ("qwen", "two images"),
    ("ov", "prompt"), ("ov", "two images")])
def test_build_dpo_pair_matches_jax(tmp_path, family, name):
    """``build_dpo_pair_from_record`` against the reference's, field for
    field (StubTokenizer, PNG files; the Qwen family on the classic
    layout): the prompt, earlier assistant turns included, fully masked;
    chosen and rejected share it. An OV record with two images raises
    ValueError (the reference asserts)."""
    from PIL import Image

    rng = np.random.RandomState(0)
    for fn, hw in (("a.png", (56, 84)), ("b.png", (84, 56))):
        Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(
            tmp_path / fn)
    rec = json.loads(json.dumps(RECORDS[name]))
    ov = family == "ov"
    kw = dict(budget=0.25, s_bucket=S_BUCKET, t_bucket=256,
              image_root=str(tmp_path), min_pixels=1, max_pixels=10**9)
    jcfg, tcfg = ((jax_ov_tiny(), llava_ov_tiny()) if ov
                  else (jax_tiny(), qwen25vl_tiny()))
    fam = "llava_ov15" if ov else "qwen25vl"
    if ov and name == "two images":
        with pytest.raises(ValueError, match="single image"):
            tdpo.build_dpo_pair_from_record(tcfg, rec, StubTokenizer(),
                                            family=fam, **kw)
        return
    extra = {} if ov else dict(align_windows=False)
    got = tdpo.build_dpo_pair_from_record(tcfg, rec, StubTokenizer(),
                                          family=fam, **kw, **extra)
    want = jdpo.build_dpo_pair_from_record(jcfg, rec, StubTokenizer(),
                                           family=fam, **kw)
    for g, w in zip(got, want):
        _check_fields(g, w, ov)
    c, r = got
    n_prompt = int(np.argmax(np.asarray(c.labels) != -100))
    assert (np.asarray(c.input_ids)[:n_prompt]
            == np.asarray(r.input_ids)[:n_prompt]).all()
    assert (np.asarray(r.labels)[:n_prompt] == -100).all()
    if name == "multi-turn":
        ids = list(np.asarray(c.input_ids))

        def find(text):
            sub = StubTokenizer().encode(text)
            return [i for i in range(len(ids)) if ids[i:i + len(sub)] == sub]

        assert find("old answer") == []
        (at,) = find("A picture.")
        assert at < n_prompt  # an earlier assistant turn: context, masked
