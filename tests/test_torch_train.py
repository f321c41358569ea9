"""The port's selector training path against the JAX package's on
qwen25vl_tiny: soft top-k and its VJP, the soft selection, the flash
attention gradient (the port's autograd Function against ``jax.vjp`` of
the JAX ``attention`` in Pallas interpret mode, kv expanded through
``_repeat_kv`` as the JAX decoder does), the composite loss and its scorer
gradients, three optimizer steps (the lr-0 first step and a clipped step
among them), gradient accumulation, remat, checkpoints and resume, the
prefetcher, the conversation dataset and the ``api.train`` CLI.

Inputs are made with numpy from a seed; fp32 throughout. Tolerances, each
stated where it is used: fp32 sum-order differences (the port's and XLA's
reductions run in different orders) relative to each tensor's largest
|value|, or absolute where the values are O(1).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.kernels import attention as jattn
from visionselector_tpu.kernels import topk as jtopk
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu.selector import select as jselect
from visionselector_tpu.train import data as jdata
from visionselector_tpu.train import dataset as jdataset
from visionselector_tpu.train import loss as jloss
from visionselector_tpu.train import train_step as jstep
from visionselector_tpu_torch.core import checkpoint as tckpt
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.kernels import attention as tattn
from visionselector_tpu_torch.kernels import topk as ttopk
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.selector import select as tselect
from visionselector_tpu_torch.train import data as tdata
from visionselector_tpu_torch.train import dataset as tdataset
from visionselector_tpu_torch.train import loss as tloss
from visionselector_tpu_torch.train import train_step as tstep
from visionselector_tpu_torch.train.prefetch import BatchPrefetcher

S_BUCKET, T_BUCKET, BUDGET = 128, 64, 0.25
K_MAX = max(1, int(S_BUCKET // 4 * BUDGET))
# 112x112: 4 windows of 16 patches; 84x112: ragged edge windows
IMAGES = [(112, 112), (84, 112)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel_err(got, want):
    """max |got - want| over the largest |want|."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------- soft top-k

@pytest.mark.parametrize("k", [1, 7, 25, 49])
def test_soft_topk_forward_and_vjp_match_jax(k):
    """B = 3, N = 50: forward within 2e-6 and VJP within 1e-5 of its max
    |value| against JAX. fp32 sums in another order move the bisection's
    threshold t by ulps of |x + t| (up to ~16 here: 1.9e-6 per ulp), and p
    moves by sigmoid' <= 1/4 of that."""
    rng = np.random.RandomState(k)
    xs = (rng.randn(3, 50) * 2).astype(np.float32)
    g = rng.randn(3, 50).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jtopk.soft_topk(x, k), jnp.asarray(xs))
    (want_dx,) = vjp(jnp.asarray(g))
    x = _t(xs).requires_grad_(True)
    got = ttopk.soft_topk(x, k)
    got.backward(_t(g))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(got.detach().sum(1).numpy(), k, rtol=1e-5)
    assert _rel_err(x.grad.numpy(), want_dx) < 1e-5


def test_soft_topk_gradcheck_float64():
    x = torch.randn(2, 12, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    assert torch.autograd.gradcheck(
        lambda a: ttopk.soft_topk(a, 4.0), (x.requires_grad_(True),),
        eps=1e-6, atol=1e-6)


def test_select_soft_matches_jax():
    """All three outputs: masked tokens and soft mask within 1e-6, the hard
    mask equal (the test asserts the score gap it relies on)."""
    full = jax_param_tree(jax_tiny(), seed=3, scorer_std=0.02)
    tree = full["scorer"]
    rng = np.random.RandomState(4)
    n_pad, n_valid, k = 40, 33, 8
    tokens = rng.randn(n_pad, tree["q_kernel"].shape[0]).astype(np.float32)
    want = jselect.select_soft(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(tokens), n_valid, k, 10)
    scorer = from_jax_params(full, qwen25vl_tiny(), "cpu").scorer
    got = tselect.select_soft(scorer, _t(tokens), n_valid, k, 10)
    scores = np.sort(np.asarray(jselect.score_tokens(
        tree, jnp.asarray(tokens), n_valid))[:n_valid])
    assert scores[-k] - scores[-k - 1] > 1e-5
    np.testing.assert_array_equal(got.hard_mask.numpy(),
                                  np.asarray(want.hard_mask))
    np.testing.assert_allclose(got.soft_mask.numpy(),
                               np.asarray(want.soft_mask), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.masked_tokens.numpy(),
                               np.asarray(want.masked_tokens), atol=1e-5,
                               rtol=0)
    assert (got.soft_mask[n_valid:] == 0).all()


# ---------------------------------------------------- flash attention gradient

def _seg_layout(kind, s):
    seg = np.zeros(s, np.int32)
    if kind == "causal":  # one segment, then padding rows
        seg[: s - s // 7] = 1
    else:  # three segments, then padding rows
        cuts = [0, s // 5, s // 2 + 3, s - s // 6]
        for i in range(3):
            seg[cuts[i]:cuts[i + 1]] = i + 1
    return seg


@pytest.mark.parametrize("kind, s", [("causal", 1024), ("causal", 600),
                                     ("segments", 1024), ("segments", 600)])
def test_flash_gradient_matches_jax_vjp(kind, s):
    """dq, dk, dv of ``attention`` (the autograd Function; ``flash_plain``
    forward on CPU tensors, the blocked mirror backward) against
    ``jax.vjp`` of the JAX ``attention(impl="pallas_interpret")`` with kv
    expanded by ``_repeat_kv``. GQA 4/2; S = 1,024 takes the blocked path
    (two 512-key blocks), S = 600 the fallback (no block divides it); the
    segment layout is non-causal, with kv bounds at S = 1,024. Padding
    rows and keys
    get zero gradients. Tolerance 1e-5 of each tensor's max |value|."""
    causal = kind == "causal"
    d, h, h_kv = 16, 4, 2
    rng = np.random.RandomState(s + causal)
    q = rng.randn(1, s, h, d).astype(np.float32)
    k, v = (rng.randn(1, s, h_kv, d).astype(np.float32) for _ in range(2))
    g = rng.randn(1, s, h, d).astype(np.float32)
    seg = _seg_layout(kind, s)[None]
    # the JAX kernel takes bounds only for lengths of whole 64-row blocks
    t_bounds = (tattn.segment_block_bounds(seg[0], 64, 64)
                if not causal and s % 64 == 0 else None)
    j_bounds = None if t_bounds is None else jnp.asarray(t_bounds)

    def jfn(q_, k_, v_):
        return jattn.attention(
            q_, jlm._repeat_kv(k_, h // h_kv), jlm._repeat_kv(v_, h // h_kv),
            jnp.asarray(seg), jnp.asarray(seg), causal=causal,
            impl="pallas_interpret", kv_bounds=j_bounds, block_q=64,
            block_k=64)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    wq, wk, wv = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tattn.attention(tq, tk, tv, _t(seg), _t(seg), causal=causal,
                          kv_bounds=t_bounds)
    assert out.grad_fn is not None
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    for got, ref in ((tq.grad, wq), (tk.grad, wk), (tv.grad, wv)):
        assert _rel_err(got.numpy(), ref) < 1e-5
    padded = seg[0] == 0
    assert (tq.grad[0, padded] == 0).all() and (tk.grad[0, padded] == 0).all()
    assert (tv.grad[0, padded] == 0).all()


def test_flash_function_only_under_grad():
    """Inference calls save nothing: no grad_fn without requires_grad or
    under no_grad; the packed entry point is differentiable too and gives
    the same gradients as ``attention``."""
    rng = np.random.RandomState(0)
    s, h, d = 128, 4, 16
    q, k, v = (_t(rng.randn(1, s, h, d).astype(np.float32)) for _ in range(3))
    seg = _t((np.arange(s) < 100).astype(np.int32)[None])
    assert tattn.attention(q, k, v, seg, seg, causal=True).grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert tattn.attention(qg, k, v, seg, seg).grad_fn is None
    grads = []
    for packed in (False, True):
        a, b_, c = (x.clone().requires_grad_(True) for x in (q, k, v))
        if packed:
            out = tattn.attention_packed(a.flatten(2), b_.flatten(2),
                                         c.flatten(2), seg, seg, h, h, d,
                                         causal=True).unflatten(-1, (h, d))
        else:
            out = tattn.attention(a, b_, c, seg, seg, causal=True)
        out.square().sum().backward()
        grads.append([x.grad for x in (a, b_, c)])
    for x, y in zip(*grads):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fault", ["delta_zero", "drop_diag_dk"])
def test_flash_backward_planted_faults_are_seen(fault):
    """The check ``chip_smoke.py`` runs (each gradient within 1e-2 of its
    max |value|) fails for both planted faults, at GQA 4/2 causal."""
    rng = np.random.RandomState(1)
    s, h, h_kv, d = 1024, 4, 2, 16
    q = _t(rng.randn(1, s, h, d).astype(np.float32))
    k, v = (_t(rng.randn(1, s, h_kv, d).astype(np.float32))
            for _ in range(2))
    g = _t(rng.randn(1, s, h, d).astype(np.float32))
    seg = _t((np.arange(s) < s - 100).astype(np.int32)[None])
    out = tattn.flash_plain(q, k, v, seg, seg, causal=True)
    good = tattn.flash_backward_plain(q, k, v, seg, seg, True, None, out, g)
    bad = tattn.flash_backward_plain(q, k, v, seg, seg, True, None, out, g,
                                     fault=fault)
    errs = [_rel_err(b.numpy(), w.numpy()) for b, w in zip(bad, good)]
    assert max(errs) > 1e-2, errs


def test_diag_function_gradient_matches_plain_autograd():
    """``attention_diag`` under grad goes through ``FlashAttentionFn``
    (``diag_plain`` forward on CPU tensors, the mirror backward with the
    window segments and no causal mask): dq, dk, dv within 1e-5 of each
    tensor's max |value| of autograd through ``diag_plain``; padding rows
    get zero gradients; without grad nothing goes through it. The fused
    ViT entry has no backward and raises under grad instead of cutting
    the graph."""
    from visionselector_tpu_torch.kernels import fused_vit_attn as tfused

    rng = np.random.RandomState(3)
    s, h, d = 256, 4, 16
    q, k, v, g = (_t(rng.randn(1, s, h, d).astype(np.float32))
                  for _ in range(4))
    seg_np = np.zeros(s, np.int32)
    for w in range(s // 16):  # windows of 12 rows in 16-row slots
        seg_np[w * 16:w * 16 + 12] = w + 1
    seg = _t(seg_np[None])
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tattn.attention_diag(*leaves, seg)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.backward(g)
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tattn.diag_plain(*refs, seg).backward(g)
    for got, ref in zip(leaves, refs):
        assert _rel_err(got.grad.numpy(), ref.grad.numpy()) < 1e-5
    assert (leaves[0].grad[0, seg_np == 0] == 0).all()
    with torch.no_grad():
        assert tattn.attention_diag(*leaves, seg).grad_fn is None
    qkv = _t(rng.randn(s, 3 * h * d).astype(np.float32)).requires_grad_(True)
    cos, sin = torch.ones(s, d), torch.zeros(s, d)
    with pytest.raises(RuntimeError, match="no backward"):
        tfused.fused_vit_attention(qkv, seg[0], cos, sin, None, h, d)
    assert tfused.fused_vit_attention(qkv, seg[0], cos, sin, None, h, d,
                                      impl="plain").grad_fn is not None


# ------------------------------------------------------------ loss and steps

@pytest.fixture(scope="module")
def model():
    jcfg = jax_tiny()
    tree = jax_param_tree(jcfg, seed=5, scorer_std=0.02)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tree)


def _port_params(tree):
    return from_jax_params(tree, qwen25vl_tiny(), "cpu")


def _batches(b=2, seed=0):
    """(JAX batch, port batch) from the same images and ids: JAX on its
    classic layout, the port on the window-aligned one it trains on."""
    rng = np.random.RandomState(seed)
    jcfg, tcfg = jax_tiny(), qwen25vl_tiny()
    js, ts = [], []
    for i in range(b):
        hw = IMAGES[(i + seed) % len(IMAGES)]
        img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
        kw = dict(prompt_before=[101, 102], prompt_after=[103],
                  answer_ids=[201 + i, 202, 203, 204][: 3 + i % 2],
                  budget=BUDGET, s_bucket=S_BUCKET, t_bucket=T_BUCKET,
                  min_pixels=1, max_pixels=10**9)
        js.append(jdata.build_train_sample(jcfg, img, **kw))
        ts.append(tdata.build_train_sample(tcfg, img, **kw))
    return (jax.tree.map(jnp.asarray, jdata.stack_samples(js)),
            tloss.to_device(tdata.stack_samples(ts), "cpu"))


@pytest.fixture(scope="module")
def batches():
    return _batches(2)


def test_selector_train_forward_matches_jax(model, batches):
    """One sample's loss, ce, bce and soft_mass within 1e-5 of JAX (the
    reference runs its classic window layout, the port the aligned one:
    the ViT computes the same function on both)."""
    jcfg, jparams, tree = model
    jb, tb = batches
    params = _port_params(tree)
    for i in range(2):
        js = jax.tree.map(lambda x: x[i], jb)
        ts = tloss.TrainBatchSample(*(
            np.asarray(x)[i] if f in tloss.HOST_FIELDS else x[i]
            for f, x in tb._asdict().items()))
        jl, jm = jax.jit(lambda p_, s_: jloss.selector_train_forward(
            p_, s_, jcfg, jnp.asarray(0.7), K_MAX))(jparams, js)
        tl, tm = tloss.selector_train_forward(params, ts, qwen25vl_tiny(),
                                              0.7, K_MAX)
        assert tl.grad_fn is None  # nothing requires grad here
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=0)
        for key in ("ce", "bce", "soft_mass"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       atol=1e-5, rtol=0)


# q_bias adds q_bias . mean(k) to every score alike, and a shift shared by
# every score leaves the soft top-k mask (and the detached hard mask)
# unchanged: its gradient is zero, and both sides hold rounding noise only
# (~1e-12 here), which Adam's normalisation turns into lr-sized steps. It
# is held to that, not compared.
ZERO_GRAD = "q_bias"


def test_scorer_gradients_match_jax_grad(model, batches):
    """Scorer gradients of the batch loss (mean of per-sample losses)
    within 1e-4 of each tensor's max |value| against ``jax.grad`` of
    ``batch_loss`` (``ZERO_GRAD`` within 1e-6 of the largest gradient on
    both sides); the frozen parameters get none."""
    jcfg, jparams, tree = model
    jb, tb = batches
    want = jax.jit(jax.grad(lambda sp: jstep.batch_loss(
        sp, jparams, jb, jcfg, jnp.asarray(1.3), K_MAX)[0]))(
        jparams["scorer"])
    params = _port_params(tree)
    tstep.init_train_state(params, tstep.ScheduleConfig())
    loss, _ = tstep.batch_loss(params, tb, qwen25vl_tiny(), 1.3, K_MAX)
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
    params = _port_params(tree)
    state = tstep.init_train_state(params, sched)
    out = []
    for _ in range(n):
        state, m = tstep.train_step(state, params, tb, qwen25vl_tiny(),
                                    K_MAX, sched)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.detach().clone() for k, v in
                     params.scorer.named_parameters()}))
    return out


def test_three_steps_match_optax(model, batches):
    """Three steps from the same parameters: scorer deltas within 1e-4 of
    each delta's max |value| (but ``ZERO_GRAD``'s), loss / grad_norm within 1e-5 relative,
    reg_weight equal and lr within 1e-6 relative of optax's schedule. The
    first step has lr 0 and moves nothing; the clip threshold is set
    between the first and the last step's gradient norm, so clipping
    engages in a later step only."""
    jcfg, jparams, tree = model
    jb, tb = batches
    free = tstep.ScheduleConfig(total_steps=3, lr=5e-3, max_grad_norm=0.0)
    norms = [m["grad_norm"] for m, _ in _port_steps(tree, tb, free)]
    assert norms[0] < norms[-1], norms  # reg_weight grows 0.1 -> 1.37
    clip = (norms[0] + norms[-1]) / 2
    sched = tstep.ScheduleConfig(total_steps=3, lr=5e-3, max_grad_norm=clip)
    jsched = jstep.ScheduleConfig(total_steps=3, lr=5e-3, max_grad_norm=clip)
    port = _port_steps(tree, tb, sched)
    lr_fn = jstep.optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=5e-3, warmup_steps=1, decay_steps=3)
    state = jstep.init_train_state(jparams, jsched)
    before = {k: np.asarray(v) for k, v in jparams["scorer"].items()}
    clipped = []
    for i, (m, scorer) in enumerate(port):
        state, jm = jstep.train_step(state, jparams, jb, jcfg, K_MAX, jsched)
        assert m["reg_weight"] == float(jm["reg_weight"])
        np.testing.assert_allclose(m["lr"], float(lr_fn(i)), rtol=1e-6)
        for key in ("loss", "grad_norm", "ce", "bce"):
            np.testing.assert_allclose(m[key], float(jm[key]), rtol=1e-5)
        for name, p in scorer.items():
            want = np.asarray(state.scorer_params[name]) - before[name]
            got = p.numpy() - before[name]
            if i == 0:
                assert m["lr"] == 0.0 and not got.any() and not want.any()
            elif name != ZERO_GRAD:
                assert _rel_err(got, want) < 1e-4, (i, name)
        clipped.append(m["grad_norm"] >= clip)
    assert clipped[0] is False and any(clipped), clipped


def test_accum_equals_big_batch_and_remat_is_exact(model):
    """``train_step_accum`` over two micro-batches of one sample equals
    ``train_step`` on the batch of two (scorer within 1e-6 of its max
    |value|, same loss); ``remat=True`` gives bit-equal gradients."""
    _, _, tree = model
    _, tb = _batches(2, seed=1)
    sched = tstep.ScheduleConfig(total_steps=4, lr=5e-3)
    micro = [tloss.TrainBatchSample(*(
        np.asarray(x)[i:i + 1] if f in tloss.HOST_FIELDS else x[i:i + 1]
        for f, x in tb._asdict().items())) for i in range(2)]
    results = []
    for accum in (False, True):
        params = _port_params(tree)
        state = tstep.init_train_state(params, sched)
        for _ in range(2):
            if accum:
                state, m = tstep.train_step_accum(
                    state, params, micro, qwen25vl_tiny(), K_MAX, sched)
            else:
                state, m = tstep.train_step(state, params, tb,
                                            qwen25vl_tiny(), K_MAX, sched)
        results.append((float(m["loss"]), params.scorer))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-6)
    for (n, a), (_, b) in zip(results[0][1].named_parameters(),
                              results[1][1].named_parameters()):
        assert _rel_err(b.detach().numpy(), a.detach().numpy()) < 1e-6, n
    grads = []
    for remat in (False, True):
        params = _port_params(tree)
        tstep.init_train_state(params, sched)
        loss, _ = tstep.batch_loss(params, tb, qwen25vl_tiny(), 1.0, K_MAX,
                                   remat=remat)
        loss.backward()
        grads.append([p.grad for p in params.scorer.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ------------------------------------------------- checkpoints and prefetch

def test_checkpoint_resume_equals_uninterrupted(model, batches, tmp_path):
    """Save after step 2, restore into a fresh state, take step 3: the
    scorer, the optimizer's moments and the step equal the run of three
    steps bit for bit; pruning keeps the newest ``keep``."""
    _, _, tree = model
    _, tb = batches
    sched = tstep.ScheduleConfig(total_steps=3, lr=5e-3)
    straight = _port_steps(tree, tb, sched)[-1][1]
    params = _port_params(tree)
    state = tstep.init_train_state(params, sched)
    out = str(tmp_path / "run")
    os.makedirs(out)
    for _ in range(2):
        state, _ = tstep.train_step(state, params, tb, qwen25vl_tiny(),
                                    K_MAX, sched)
        tckpt.save_train_state(state, out, keep=1)
    assert sorted(os.listdir(out)) == ["checkpoint-2"]
    assert tckpt.latest_checkpoint(out).endswith("checkpoint-2")
    fresh = _port_params(tree)
    state2, resumed = tckpt.maybe_resume(
        out, tstep.init_train_state(fresh, sched))
    assert resumed and state2.step == 2
    state2, _ = tstep.train_step(state2, fresh, tb, qwen25vl_tiny(), K_MAX,
                                 sched)
    for name, p in fresh.scorer.named_parameters():
        assert torch.equal(p.detach(), straight[name]), name
    for s in (3, 4):
        tckpt.save_train_state(state2, out, step=s, keep=2)
    assert sorted(os.listdir(out)) == ["checkpoint-3", "checkpoint-4"]
    empty = str(tmp_path / "none")
    assert tckpt.maybe_resume(empty, state2) == (state2, False)


def test_prefetcher_order_errors_and_close():
    counter = iter(range(100))
    pf = BatchPrefetcher(lambda: next(counter), size=3)
    assert [next(pf) for _ in range(10)] == list(range(10))
    pf.close(timeout=5)
    assert not pf._thread.is_alive()

    def flaky(state={"n": 0}):
        state["n"] += 1
        if state["n"] == 3:
            raise ValueError("bad batch")
        return state["n"]

    pf = BatchPrefetcher(flaky, size=2)
    assert [next(pf), next(pf)] == [1, 2]
    with pytest.raises(ValueError, match="bad batch"):
        next(pf)
    pf.close(timeout=5)
    assert not pf._thread.is_alive()
    with pytest.raises(ValueError):
        BatchPrefetcher(lambda: 0, size=0)


# --------------------------------------------------------------- dataset

class StubTokenizer:
    """One id per character; never an image or vision-marker id."""

    def encode(self, text):
        return [ord(c) % 500 + 10 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def _write_dataset(tmp_path, bad_image_at=None):
    from PIL import Image

    rng = np.random.RandomState(0)
    for name, hw in (("a.png", (112, 112)), ("b.png", (84, 112))):
        Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(
            tmp_path / name)
    ann = tmp_path / "data.jsonl"
    recs = [
        {"id": 0, "image": "a.png", "conversations": [
            {"from": "human", "value": "<image>Q0?"},
            {"from": "gpt", "value": "A0"}]},
        {"id": 1, "image": ["a.png", "b.png"], "conversations": [
            {"from": "human", "value": "<image>and<image>Q1?"},
            {"from": "gpt", "value": "Ans"}]},
        {"id": 2, "image": "missing.png" if bad_image_at == 2 else "b.png",
         "conversations": [{"from": "user", "value": "Hi <image>"},
                           {"from": "assistant", "value": "Yo"},
                           {"from": "human", "value": "more?"},
                           {"from": "gpt", "value": "B"}]},
    ]
    with open(ann, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return str(ann)


def test_dataset_records_match_jax_field_for_field(tmp_path):
    """render_conversation equal; every ``TrainBatchSample`` field of the
    reference's (the vision batch on its classic layout) equal but the kv
    bounds, which the port builds at its 64-row tile; one and two images
    per record."""
    ann = _write_dataset(tmp_path)
    tok = StubTokenizer()
    jds = jdataset.ConversationDataset(ann, str(tmp_path), tok)
    tds = tdataset.ConversationDataset(ann, str(tmp_path), tok)
    assert len(jds) == len(tds) == 3
    for i in range(3):
        jr, tr = jds[i], tds[i]
        for key in ("ids", "labels", "image_slot", "image_slots", "id"):
            assert jr[key] == tr[key], key
        assert (tdataset.render_conversation(tds.records[i]["conversations"],
                                             tok)
                == jdataset.render_conversation(
                    jds.records[i]["conversations"], tok))
        js = jdataset.build_sample_from_record(
            jax_tiny(), jr, BUDGET, 256, 256, min_pixels=1, max_pixels=10**9)
        ts = tdataset.build_sample_from_record(
            qwen25vl_tiny(), tr, BUDGET, 256, 256, min_pixels=1,
            max_pixels=10**9, align_windows=False)
        for f in js._fields:
            if f.endswith("kv_bounds"):
                continue
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                          err_msg=f)


def test_dataset_fallback_and_registry(tmp_path):
    ann = _write_dataset(tmp_path, bad_image_at=2)
    ds = tdataset.ConversationDataset(ann, str(tmp_path), StubTokenizer())
    rec = ds[2]  # the image is missing: a neighbour instead
    assert rec["id"] != 2 and rec["image"] is not None
    reg = {"coco": {"annotation_path": "a.jsonl", "data_path": "imgs"},
           "chartqa": {"annotation_path": "b.jsonl"}}
    specs = tdataset.parse_dataset_names("coco%10, chartqa", reg)
    assert [(s.name, s.sampling_rate, s.data_path) for s in specs] == [
        ("coco", pytest.approx(0.1), "imgs"), ("chartqa", 1.0, "")]


# ------------------------------------------------------------------- CLI

def test_train_cli_smoke_writes_log_checkpoint_and_scorer(tmp_path, capsys):
    """``api.train --smoke --device cpu --total-steps 3``: train_log.jsonl
    with three lines, checkpoint-3, and a scorer the JAX loader reads; a
    second run resumes and takes no step."""
    from visionselector_tpu.models.qwen25vl.weights import (
        _open_checkpoint,
        load_scorer_params,
    )
    from visionselector_tpu_torch.api import train as tapi

    out = str(tmp_path / "smoke")
    argv = ["--smoke", "--device", "cpu", "--total-steps", "3",
            "--batch-size", "2", "--log-steps", "1", "--output-dir", out]
    assert tapi.main(argv) == 0
    with open(os.path.join(out, "train_log.jsonl")) as f:
        log = [json.loads(ln) for ln in f]
    assert [m["step"] for m in log] == [1, 2, 3]
    assert log[0]["lr"] == 0.0 and all(np.isfinite(m["loss"]) for m in log)
    assert os.path.isdir(os.path.join(out, "checkpoint-3"))
    assert os.path.isfile(os.path.join(out, "importance_scorer.safetensors"))
    jsc = load_scorer_params(_open_checkpoint(out))
    assert jsc["q_kernel"].shape == (96, 48)
    capsys.readouterr()
    assert tapi.main(argv) == 0
    assert "resumed at step 3" in capsys.readouterr().out
    with open(os.path.join(out, "train_log.jsonl")) as f:
        assert len(f.readlines()) == 3


@pytest.mark.parametrize("extra, error", [
    (["--family", "llava_ov15", "--data-flatten"], ValueError),
    (["--data-flatten"], ValueError),  # packing needs --annotation records
    (["--family", "llava_ov15", "--method", "dynamic"], ValueError),
    (["--lora-rank", "8"], ValueError),  # adapters train under sft/dpo/grpo
    (["--method", "grpo", "--num-generations", "1"], ValueError),
    (["--method", "grpo", "--grad-accum-steps", "2", "--grpo-loss-type",
      "bnpo"], ValueError),
    (["--method", "grpo", "--grad-accum-steps", "2", "--grpo-loss-type",
      "dr_grpo"], ValueError),
])
def test_train_cli_unported_options_raise(tmp_path, extra, error):
    """Combinations the reference ignores without a word, or asserts
    against (one GRPO generation; GRPO accumulation under a reduction by
    the whole batch's token counts), raise ValueError."""
    from visionselector_tpu_torch.api import train as tapi

    with pytest.raises(error):
        tapi.main(["--smoke", "--device", "cpu", "--output-dir",
                   str(tmp_path)] + extra)


@pytest.mark.parametrize("extra, outputs", [
    (["--method", "sft"], []),
    (["--method", "dynamic"], ["image_score_predictor.safetensors"]),
    (["--data-flatten"], ["importance_scorer.safetensors"]),
    (["--method", "sft", "--lora-rank", "8"], ["lora_merged/params.pt"]),
    (["--async-save"], ["importance_scorer.safetensors"]),
    (["--method", "dpo"], []),
    (["--method", "dpo", "--grad-accum-steps", "2", "--dpo-loss-type",
      "ipo", "--family", "llava_ov15", "--lora-rank", "8"],
     ["lora_merged/params.pt"]),
    (["--method", "grpo", "--max-completion-length", "6"], []),
    (["--method", "grpo", "--max-completion-length", "6", "--family",
      "llava_ov15", "--lora-rank", "8", "--grpo-beta", "0"],
     ["lora_merged/params.pt"]),
])
def test_train_cli_methods_write_outputs(tmp_path, monkeypatch, extra,
                                         outputs):
    """``api.train --device cpu --total-steps 3`` with each option that
    replaced a refusal: three log lines of finite losses, checkpoint-3
    (holding the method's trained tensors) and the method's export; a
    second run resumes and takes no step. ``--data-flatten`` trains on
    the annotation file of ``_write_dataset`` (its one-image records
    packed, the two-image one unpacked) with ``StubTokenizer``; the others
    on the tiny config's synthetic data (DPO's pairs, GRPO's prompts with
    6-token rollouts; both families, full model and LoRA, IPO with
    accumulation, GRPO without a reference at beta 0). DPO's first step
    has a zero margin (the policy is the reference); GRPO logs a
    mean_reward in [0, 1]. The exports load: the predictor through
    ``load_predictor``, the merged model as a state dict without
    adapters."""
    from visionselector_tpu_torch.api import train as tapi
    from visionselector_tpu_torch.core.checkpoint import STATE_FILE

    out = str(tmp_path / "run")
    argv = ["--device", "cpu", "--total-steps", "3", "--batch-size", "2",
            "--log-steps", "1", "--output-dir", out] + extra
    if "--data-flatten" in extra:
        monkeypatch.setattr(tapi, "_tokenizer", lambda path: StubTokenizer())
        argv += ["--annotation", _write_dataset(tmp_path), "--image-root",
                 str(tmp_path), "--vision-bucket", "256", "--text-bucket",
                 "512"]
    else:
        argv.append("--smoke")
    if "grpo" in extra:
        # the rollouts' decode loop: one intra-op thread (its small ops
        # stall on oversubscribed threads in the parallel Tier-1 run)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
        try:
            assert tapi.main(argv) == 0
        finally:
            monkeypatch.undo()
            torch.set_num_threads(threads)
    else:
        assert tapi.main(argv) == 0
    with open(os.path.join(out, "train_log.jsonl")) as f:
        log = [json.loads(ln) for ln in f]
    assert [m["step"] for m in log] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) for m in log)
    if "dpo" in extra:  # the policy starts as the reference: ln 2 at step 0
        assert log[0]["reward_margin"] == 0.0
    if "grpo" in extra:
        assert all(0.0 <= m["mean_reward"] <= 1.0 for m in log)
        assert ("kl" in log[0]) == ("--grpo-beta" not in extra)
    blob = torch.load(os.path.join(out, "checkpoint-3", STATE_FILE),
                      weights_only=True)
    assert blob["step"] == 3 and blob["params"]
    for name in outputs:
        assert os.path.isfile(os.path.join(out, name)), name
    if "dynamic" in extra:
        from visionselector_tpu_torch.train.dynamic_train import (
            load_predictor,
        )

        pred = load_predictor(os.path.join(out, outputs[0]), "cpu", 4)
        assert pred.down_kernel.shape == (96, 64) and "generator" in blob
    if "--lora-rank" in extra:
        merged = torch.load(os.path.join(out, outputs[0]), weights_only=True)
        assert "lm.layers.0.q_kernel" in merged
        assert not any("_lora_" in n for n in merged)
        assert all("_lora_" in n for n in blob["params"])
    assert tapi.main(argv) == 0
    with open(os.path.join(out, "train_log.jsonl")) as f:
        assert len(f.readlines()) == 3


PREF_RECORDS = {
    "dpo": [
        {"image": "a.png", "prompt": "What is it?", "chosen": "A cat.",
         "rejected": "A dog, surely."},
        {"image": ["a.png", "b.png"], "prompt": "<image>vs<image>: which?",
         "chosen": "Left.", "rejected": "Right."},
        {"image": "b.png", "conversations": [
            {"from": "human", "value": "<image>Describe."},
            {"from": "gpt", "value": "A picture."},
            {"from": "human", "value": "Color?"},
            {"from": "gpt", "value": "old"}],
         "chosen": "Red.", "rejected": "Blue."}],
    "grpo": [
        {"image": "a.png", "prompt": "Add 1 and 1.",
         "solution": "<answer>2</answer>"},
        {"image": ["a.png", "b.png"], "prompt": "<image> or <image>?",
         "answer": "left"},
        {"image": "b.png", "conversations": [
            {"from": "human", "value": "<image>How many?"},
            {"from": "gpt", "value": "old"}], "solution": "3"}],
}


@pytest.mark.parametrize("method", ["dpo", "grpo"])
def test_train_cli_preference_annotation(tmp_path, monkeypatch, method):
    """``--method dpo|grpo --annotation``: the reference's preference and
    prompt records (a prompt with one image, two images, a conversation
    whose last assistant turn is dropped) through ``StubTokenizer`` (GRPO's
    rewards read its decoded text): three log lines of finite losses,
    checkpoint-3; GRPO's mean_reward is the accuracy + format rewards' mean
    over the rollouts, in [0, 2]."""
    from visionselector_tpu_torch.api import train as tapi

    _write_dataset(tmp_path)  # a.png, b.png
    ann = tmp_path / f"{method}.json"
    ann.write_text(json.dumps(PREF_RECORDS[method]))  # a json list
    monkeypatch.setattr(tapi, "_tokenizer", lambda path: StubTokenizer())
    out = str(tmp_path / "run")
    argv = ["--device", "cpu", "--total-steps", "3", "--batch-size", "2",
            "--log-steps", "1", "--output-dir", out, "--method", method,
            "--annotation", str(ann), "--image-root", str(tmp_path),
            "--vision-bucket", "256", "--text-bucket", "512",
            "--num-generations", "2", "--max-completion-length", "4"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the rollouts' decode loop (see above)
    try:
        assert tapi.main(argv) == 0
    finally:
        torch.set_num_threads(threads)
    with open(os.path.join(out, "train_log.jsonl")) as f:
        log = [json.loads(ln) for ln in f]
    assert [m["step"] for m in log] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) for m in log)
    assert os.path.isdir(os.path.join(out, "checkpoint-3"))
    if method == "grpo":
        assert all(0.0 <= m["mean_reward"] <= 2.0 for m in log)


def test_reg_weight_schedule_matches_jax():
    for step in (0, 1, 7, 50, 99, 100, 250):
        assert tloss.reg_weight_schedule(step, 100, 0.1, 2.0) == float(
            jloss.reg_weight_schedule(jnp.asarray(step), 100, 0.1, 2.0))
