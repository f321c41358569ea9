"""The port's sampling against the JAX package's: ``sample_token`` given the
Gumbel noise JAX's ``_sample_token`` draws for the same key (the same
token for every key, so the same kept set at top-k / top-p edges),
``penalize_logits`` and ``rep_penalty_setup``; and text-only and
repetition-penalized greedy ``generate`` on qwen25vl_tiny equal to the JAX
engine's tokens (fp32, same weights)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params

N_KEYS = 400


@jax.jit
def _jax_draws(logits, keys, temperature, top_p, top_k):
    """(tokens [N], the Gumbel noise each key's draw adds [N, V])."""
    toks = jax.vmap(jmodel._sample_token, (None, 0, None, None, None))(
        logits, keys, temperature, top_p, top_k)
    # _sample_token splits nothing: categorical(key, ...) adds
    # gumbel(key, (V,)) in sorted-position order
    noise = jax.vmap(lambda k: jax.random.gumbel(
        k, logits.shape, jnp.float32))(keys)
    return toks, noise


def _port_draws(logits, noise, temperature, top_p, top_k):
    lg = torch.from_numpy(logits)[None].expand(len(noise), -1)
    return tmodel.sample_token(lg, torch.from_numpy(np.array(noise)),
                               temperature, top_p, top_k).numpy()


# (temperature, top_p, top_k): plain nucleus, top-k then renormalised
# top-p, top-k 1 (greedy), top-p below the top token's mass (only it is
# kept), top-k past V, and greedy (the noise is ignored).
CASES = [(0.7, 0.9, 0), (1.0, 0.5, 5), (0.8, 1.0, 1), (1.3, 1e-4, 0),
         (0.5, 0.95, 100), (0.0, 0.9, 0)]


@pytest.mark.parametrize("temperature,top_p,top_k", CASES)
def test_sample_token_matches_jax_draws(temperature, top_p, top_k):
    rng = np.random.RandomState(1)
    logits = (rng.randn(40) * 2).astype(np.float32)
    logits[[3, 17]] = logits.max() + 0.5  # a tie at the top
    keys = jax.random.split(jax.random.PRNGKey(7), N_KEYS)
    want, noise = _jax_draws(jnp.asarray(logits), keys, temperature, top_p,
                             top_k)
    got = _port_draws(logits, noise, temperature, top_p, top_k)
    np.testing.assert_array_equal(got, np.asarray(want))
    kept = set(got.tolist())
    if temperature == 0.0 or top_k == 1 or top_p < 0.01:
        assert kept == {3}  # the tie keeps the lower index first
    elif top_k:
        assert kept <= set(np.argsort(-logits, kind="stable")[:top_k])
        assert len(kept) > 1


def test_sample_token_batched_rows_match_single():
    """A [S, V] call (the slot pool) gives each row what a [V] call gives,
    greedy rows included."""
    rng = np.random.RandomState(2)
    logits = torch.from_numpy(rng.randn(4, 50).astype(np.float32))
    noise = torch.from_numpy(rng.gumbel(size=(4, 50)).astype(np.float32))
    temps = torch.tensor([0.7, 0.0, 1.2, 0.9])
    tps = torch.tensor([0.9, 1.0, 0.6, 1.0])
    tks = torch.tensor([0, 0, 7, 3])
    rows = tmodel.sample_token(logits, noise, temps, tps, tks)
    for i in range(4):
        one = tmodel.sample_token(logits[i], noise[i], float(temps[i]),
                                  float(tps[i]), int(tks[i]))
        assert int(one) == int(rows[i])
    assert int(rows[1]) == int(logits[1].argmax())


def test_penalize_logits_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 30).astype(np.float32)
    pres = rng.rand(3, 30) < 0.4
    pen = np.asarray([1.1, 1.0, 1.7], np.float32)[:, None]
    want = jmodel._penalize_logits(jnp.asarray(logits), jnp.asarray(pres),
                                   jnp.asarray(pen))
    got = tmodel.penalize_logits(torch.from_numpy(logits),
                                 torch.from_numpy(pres), torch.from_numpy(pen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rep_penalty_setup_matches_jax():
    rng = np.random.RandomState(5)
    v = 64
    logits = rng.randn(v).astype(np.float32)
    ids = np.asarray([3, 9, 9, 40])
    logits[9] = logits.max() + 0.05  # the penalty moves the top token
    jp, jfirst = jmodel._rep_penalty_setup(v, ids, jnp.asarray(logits), 9,
                                           1.3)
    tp, tfirst = tmodel.rep_penalty_setup(v, ids, torch.from_numpy(logits),
                                          9, 1.3)
    assert tfirst == jfirst != 9
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # no logits (the prefill did not expose them): the token is kept
    tp2, first2 = tmodel.rep_penalty_setup(v, ids, None, 11, 1.3)
    assert first2 == 11 and tp2[[3, 9, 40, 11]].all() and tp2.sum() == 4
    # sampled: a draw from the request's first-token stream, reproducible
    lg = torch.from_numpy(logits)
    _, s1 = tmodel.rep_penalty_setup(v, ids, lg, 9, 1.3, 0.8, 0.9, 0, 3)
    _, s2 = tmodel.rep_penalty_setup(v, ids, lg, 9, 1.3, 0.8, 0.9, 0, 3)
    gen = tmodel.sampling_generator(3, "cpu", tmodel.FIRST_STREAM)
    pen = tmodel.penalize_logits(lg, tp, 1.3)
    want = tmodel.sample_token(pen, tmodel.gumbel_noise(gen, v), 0.8, 0.9)
    assert s1 == s2 == int(want)


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_tiny()
    tree = jax_param_tree(jcfg, seed=1)
    jeng = jmodel.QwenVLEngine(jcfg, jax.tree.map(jnp.asarray, tree))
    teng = tmodel.QwenVLEngine(qwen25vl_tiny(),
                               from_jax_params(tree, qwen25vl_tiny(), "cpu"),
                               device="cpu")
    return jeng, teng


@pytest.mark.parametrize("n_ids,rp", [(7, 1.0), (150, 1.0), (20, 1.3)])
def test_text_only_generate_matches_jax(engines, n_ids, rp):
    """Text-only prefill (1-D rope, 128-padded bucket) + greedy decode,
    with and without a repetition penalty."""
    jeng, teng = engines
    ids = np.random.RandomState(n_ids).randint(10, 5000, n_ids)
    want = jeng.generate(ids, max_new_tokens=8, eos_token_ids=(-1,),
                         repetition_penalty=rp)
    got = teng.generate(ids, max_new_tokens=8, eos_token_ids=(-1,),
                        repetition_penalty=rp)
    assert got.tokens == want.tokens and len(got.tokens) == 8
    assert got.prefill_len == want.prefill_len == n_ids
    assert got.num_vision_tokens == 0 and got.selected_indices is None


def test_sampled_generate_is_seeded(engines):
    """A sampled one-shot rollout depends on its seed only; the greedy one
    equals temperature 0."""
    _, teng = engines
    ids = np.arange(30, 42)
    kw = dict(max_new_tokens=10, eos_token_ids=(-1,), temperature=1.5,
              top_p=0.95, top_k=40)
    a = teng.generate(ids, seed=3, **kw).tokens
    assert a == teng.generate(ids, seed=3, **kw).tokens
    assert a != teng.generate(ids, seed=4, **kw).tokens
    greedy = teng.generate(ids, max_new_tokens=10, eos_token_ids=(-1,))
    assert teng.generate(ids, seed=3, **dict(kw, temperature=0.0)).tokens \
        == greedy.tokens
