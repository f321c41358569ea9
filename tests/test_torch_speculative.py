"""One-shot prompt-lookup speculative decoding of the port
(``models/qwen25vl/model.py``'s last section) against the JAX package's on
the tiny configs (fp32, 4 decoder layers where an LLM-side strategy needs
them), with the same weights and numpy inputs: the proposals, the nucleus
distributions (within 1e-6), the acceptance rule (bit-equal given JAX's
uniforms and Gumbel noise for the same key, and the target law checked
empirically), one verify step (greedy rows, a and the rolled-back
per-layer lengths), and ``generate_speculative`` (greedy, m = 3 and 7:
tokens, ``decode_dispatches`` and the proposal counts) on the selector,
``orig``, FastV and the OV family, against JAX's and the port's own
``generate``; the repetition-penalty fallback and seeded sampled runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ov_params import configs as ov_configs
from torch_ov_params import ov_tree, port_params
from torch_ov_params import requests as ov_requests
from torch_serving_params import (  # noqa: F401 (one_thread: autouse)
    EOS,
    one_thread,
    serving_engines,
)

from visionselector_tpu.models.llava_ov15 import model as jov
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu_torch.models.llava_ov15 import model as tov
from visionselector_tpu_torch.models.qwen25vl import model as tmodel

NEW_TOKENS = 12


@pytest.fixture(scope="module")
def w():
    return serving_engines()


@pytest.fixture(scope="module")
def ov():
    tree = ov_tree()
    jcfg, tcfg = ov_configs()
    return (jov.OVEngine(jcfg, jax.tree.map(jnp.asarray, tree), budget=0.3),
            tov.OVEngine(tcfg, port_params(tree), budget=0.3, device="cpu"))


def _req(w, question=(8, 9, 8, 9, 10)):
    return dict(input_ids=w["ids_for"](list(question)),
                pixel_values=w["px"], grid_thw=w["grid"])


@pytest.mark.parametrize("n, m", [(3, 4), (2, 3), (1, 7)])
def test_prompt_lookup_matches_jax(n, m):
    rng = np.random.RandomState(n * 10 + m)
    cases = [[], [5], list(range(n)), [1, 2, 3, 9, 9, 1, 2, 3],
             [5, 6, 7, 5, 6], [9, 8, 4, 9, 8], [1, 2, 3, 4]]
    cases += [rng.randint(0, 5, size=rng.randint(1, 30)).tolist()
              for _ in range(20)]
    for ctx in cases:
        assert tmodel._prompt_lookup(ctx, n, m) == \
            jmodel._prompt_lookup(ctx, n, m), ctx


@pytest.mark.parametrize("temperature, top_p, top_k", [
    (0.7, 0.9, 0), (1.3, 0.5, 5), (0.3, 1.0, 3)])
def test_nucleus_probs_matches_jax(temperature, top_p, top_k):
    """Within 1e-6 of JAX's, on rows with tied logits (the stable sort
    breaks ties as ``jnp.argsort``)."""
    rng = np.random.RandomState(int(temperature * 10))
    logits = rng.randn(6, 40).astype(np.float32) * 3
    logits[:, 10:20] = logits[:, 0:1]  # ties at each row's first value
    logits[2, :] = 1.0  # a row of ties only
    want = jmodel._nucleus_probs(jnp.asarray(logits), temperature, top_p,
                                 top_k)
    got = tmodel._nucleus_probs(torch.from_numpy(logits), temperature,
                                top_p, top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


def _jax_draws(key, m, v):
    """The uniforms and Gumbel noise ``jmodel._spec_accept`` draws from
    ``key``: ``u`` from the first split, the categorical's noise from the
    second."""
    ku, kr = jax.random.split(key)
    return jax.random.uniform(ku, (m,)), jax.random.gumbel(kr, (v,))


def _target(m, v, seed):
    p = np.random.RandomState(seed).rand(m + 1, v).astype(np.float32) + 0.05
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("m", [3, 7])
def test_spec_accept_bit_equal_to_jax(m):
    """Given JAX's uniforms and Gumbel noise for each key, (emitted, a)
    equal JAX's ``_spec_accept`` bit for bit, over 300 keys, on peaked
    rows with proposals mostly at their peaks (so every a from 0 to m
    occurs)."""
    v = 13
    rng = np.random.RandomState(m)
    peak = rng.randint(0, v, m + 1)
    probs = _target(m, v, m)
    probs[np.arange(m + 1), peak] += 8.0
    probs /= probs.sum(-1, keepdims=True)
    props = np.where(rng.rand(300, m) < 0.9, peak[:m],
                     rng.randint(0, v, (300, m))).astype(np.int64)
    keys = jax.random.split(jax.random.PRNGKey(m), 300)
    pj = jnp.asarray(probs)
    je, ja = jax.vmap(lambda k, pr: jmodel._spec_accept(pj, pr, k))(
        keys, jnp.asarray(props))
    u, g = jax.vmap(lambda k: _jax_draws(k, m, v))(keys)
    te, ta = tmodel._spec_accept(
        torch.from_numpy(probs).expand(300, m + 1, v),
        torch.from_numpy(props), torch.from_numpy(np.array(u)),
        torch.from_numpy(np.array(g)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    seen = set(ta.tolist())
    assert seen == set(range(m + 1)), seen


def _accept_draws(probs, props, n, seed):
    """``n`` acceptances of (probs, props) with the port's own draws."""
    p = torch.from_numpy(probs).expand(n, *probs.shape)
    pr = torch.as_tensor(props).expand(n, len(props))
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand(n, len(props), generator=gen)
    g = -torch.log(-torch.log(torch.rand(n, probs.shape[1], generator=gen)))
    emitted, a = tmodel._spec_accept(p, pr, u, g)
    return emitted.numpy(), a.numpy()


def test_spec_accept_first_token_marginal_matches_target():
    probs = _target(3, 13, 0)
    emitted, _ = _accept_draws(probs, [4, 7, 2], 8000, 42)
    emp = np.bincount(emitted[:, 0], minlength=13) / 8000
    # 8,000 draws, V = 13: ~3 sigma on each cell is about 0.017
    np.testing.assert_allclose(emp, probs[0], atol=0.02)


def test_spec_accept_second_token_conditional_matches_target():
    probs = _target(3, 13, 3)
    emitted, a = _accept_draws(probs, [1, 9, 5], 12000, 7)
    sel = emitted[a >= 1, 1]  # token 1 means something only when a >= 1
    emp = np.bincount(sel, minlength=13) / len(sel)
    np.testing.assert_allclose(emp, probs[1], atol=0.025)


def test_spec_accept_emits_accepted_drafts_and_point_masses():
    probs = _target(3, 13, 5)
    emitted, a = _accept_draws(probs, [2, 2, 8], 64, 0)
    for e, ai in zip(emitted, a):
        assert (e[:ai] == [2, 2, 8][:ai]).all()
    point = np.zeros((4, 11), np.float32)
    point[:, 6] = 1.0
    emitted, a = _accept_draws(point, [6, 6, 6], 8, 1)
    assert (a == 3).all() and (emitted == 6).all()


def test_spec_verify_step_matches_jax(w):
    """One greedy verify step on the FastV cache (per-layer lengths) with
    proposals half right: its greedy rows, a and the rolled-back
    lengths equal JAX's."""
    m = 4
    req = _req(w)
    want = w["tfastv"].generate(**req, max_new_tokens=8,
                                eos_token_ids=EOS).tokens
    props = np.asarray(want[1:3] + [7, 7], np.int64)
    js = w["jfastv"].generate(**req, max_new_tokens=8 + m + 1,
                              eos_token_ids=EOS, _defer_decode=True)
    ts = w["tfastv"].generate(**req, max_new_tokens=8 + m + 1,
                              eos_token_ids=EOS, _defer_decode=True)
    len0 = np.asarray(js.cache.length)
    assert len(set(len0[:, 0])) == 2  # per-layer lengths
    jg, ja, jc = jmodel._spec_verify(
        w["jfastv"].params, js.cache, jnp.asarray(js.next_token, jnp.int32),
        jnp.asarray(props, jnp.int32), jnp.asarray(js.start_pos, jnp.int32),
        w["jfastv"].cfg, m)
    tg, ta, tc = tmodel._spec_verify(
        w["tfastv"].params, ts.cache, torch.tensor(ts.next_token),
        torch.from_numpy(props), ts.start_pos)
    assert tg.tolist() == np.asarray(jg).tolist()
    assert int(ta) == int(ja) == 2
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_array_equal(tc.length.numpy(), len0 + 3)


GENERATE_CASES = [(e, m) for e in ("sel", "orig", "fastv", "ov")
                  for m in (3, 7)]


@pytest.mark.parametrize("kind, m", GENERATE_CASES,
                         ids=[f"{e}-m{m}" for e, m in GENERATE_CASES])
def test_generate_speculative_matches_jax(w, ov, kind, m):
    """Greedy: the tokens, ``decode_dispatches``, ``spec_proposed`` and
    ``spec_accepted`` equal JAX's ``generate_speculative``, and the tokens
    equal the port's plain ``generate``."""
    if kind == "ov":
        jeng, teng = ov
        req = ov_requests()["image"]
    else:
        jeng, teng = w["j" + kind], w["t" + kind]
        req = _req(w)
    kw = dict(max_new_tokens=NEW_TOKENS, eos_token_ids=EOS, propose_len=m,
              ngram=2)
    want = jmodel.generate_speculative(jeng, **req, **kw)
    got = tmodel.generate_speculative(teng, **req, **kw)
    plain = teng.generate(**req, max_new_tokens=NEW_TOKENS,
                          eos_token_ids=EOS)
    assert got.tokens == want.tokens == plain.tokens
    assert (got.decode_dispatches, got.spec_proposed, got.spec_accepted) \
        == (want.decode_dispatches, want.spec_proposed,
            want.spec_accepted)
    assert got.spec_proposed == m * got.decode_dispatches
    assert got.decode_dispatches + got.spec_accepted \
        >= len(got.tokens) - 1
    assert len(set(got.tokens)) > 1


def test_spec_verify_accepts_the_true_continuation(w):
    """Proposals that ARE the plain decode's next m tokens: one verify step
    accepts all m, emits m + 1 tokens of the plain decode, and advances
    every layer's length by m + 1, as JAX's does (the mechanism, with no
    reliance on the model echoing its prompt)."""
    m = 4
    req = _req(w)
    want = w["tsel"].generate(**req, max_new_tokens=8,
                              eos_token_ids=EOS).tokens
    props = np.asarray(want[1:1 + m], np.int64)
    ts = w["tsel"].generate(**req, max_new_tokens=8 + m + 1,
                            eos_token_ids=EOS, _defer_decode=True)
    js = w["jsel"].generate(**req, max_new_tokens=8 + m + 1,
                            eos_token_ids=EOS, _defer_decode=True)
    len0 = ts.cache.length.clone()
    tg, ta, tc = tmodel._spec_verify(
        w["tsel"].params, ts.cache, torch.tensor(ts.next_token),
        torch.from_numpy(props), ts.start_pos)
    _, ja, _ = jmodel._spec_verify(
        w["jsel"].params, js.cache, jnp.asarray(js.next_token, jnp.int32),
        jnp.asarray(props, jnp.int32), jnp.asarray(js.start_pos, jnp.int32),
        w["jsel"].cfg, m)
    assert int(ta) == int(ja) == m
    assert tg.tolist() == want[1:2 + m]
    assert torch.equal(tc.length, len0 + m + 1)


def test_generate_speculative_with_mostly_right_proposals(w, monkeypatch):
    """Both packages' lookups replaced by one that proposes the plain
    decode's continuation with every third proposal wrong: multi-token
    accepts and roll-backs over the in-place cache, the same tokens,
    dispatches and accepted counts as JAX, fewer steps than tokens."""
    req = _req(w)
    plain = w["tsel"].generate(**req, max_new_tokens=16,
                               eos_token_ids=EOS).tokens
    n_prompt = len(req["input_ids"])

    def lookup(ctx, n, m):
        done = len(ctx) - n_prompt
        props = (plain[done:done + m] + [0] * m)[:m]
        return [t if (done + i) % 3 else 1 for i, t in enumerate(props)]

    monkeypatch.setattr(tmodel, "_prompt_lookup", lookup)
    monkeypatch.setattr(jmodel, "_prompt_lookup", lookup)
    kw = dict(max_new_tokens=16, eos_token_ids=EOS, propose_len=3)
    got = tmodel.generate_speculative(w["tsel"], **req, **kw)
    want = jmodel.generate_speculative(w["jsel"], **req, **kw)
    assert got.tokens == want.tokens == plain
    assert (got.decode_dispatches, got.spec_accepted) == (
        want.decode_dispatches, want.spec_accepted)
    assert got.spec_accepted > 0
    assert got.decode_dispatches < len(got.tokens) - 1


def test_generate_speculative_eos_and_budget(w):
    """An EOS stops the decode as the plain loop does (the result leaves
    it out), and a budget of one token takes no verify step."""
    req = _req(w)
    plain = w["tsel"].generate(**req, max_new_tokens=10, eos_token_ids=EOS)
    eos = (plain.tokens[4],)
    got = tmodel.generate_speculative(w["tsel"], **req, max_new_tokens=10,
                                      eos_token_ids=eos, propose_len=3)
    assert got.tokens == w["tsel"].generate(
        **req, max_new_tokens=10, eos_token_ids=eos).tokens
    assert eos[0] not in got.tokens
    one = tmodel.generate_speculative(w["tsel"], **req, max_new_tokens=1,
                                      eos_token_ids=EOS)
    assert one.tokens == plain.tokens[:1] and one.decode_dispatches == 0


def test_repetition_penalty_falls_back_to_generate(w):
    req = _req(w)
    got = tmodel.generate_speculative(w["tsel"], **req, max_new_tokens=8,
                                      eos_token_ids=EOS,
                                      repetition_penalty=1.3)
    want = w["tsel"].generate(**req, max_new_tokens=8, eos_token_ids=EOS,
                              repetition_penalty=1.3)
    assert got.tokens == want.tokens
    assert got.spec_proposed is None and got.decode_dispatches is None


def test_sampled_speculative_is_seeded(w):
    """Sampled runs repeat under one seed and differ under another; a
    temperature near 0 collapses the nucleus target to the greedy token,
    so the run equals the greedy decode."""
    req = _req(w)

    def run(seed, temperature=0.8):
        return tmodel.generate_speculative(
            w["tsel"], **req, max_new_tokens=10, eos_token_ids=EOS,
            temperature=temperature, top_p=0.95, seed=seed,
            propose_len=3).tokens

    a, b = run(11), run(11)
    assert a == b and len(a) == 10
    assert run(12) != a
    greedy = w["tsel"].generate(**req, max_new_tokens=10,
                                eos_token_ids=EOS).tokens
    assert run(5, temperature=1e-6) == greedy
