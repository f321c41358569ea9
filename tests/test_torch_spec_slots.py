"""The port's speculative batcher slots (``continuous._lookup_props``,
``_spec_rounds``, ``ContinuousBatcher(speculative=m)``) on qwen25vl_tiny
(fp32), against the JAX package's and the per-request oracle: the on-device
lookup equal to JAX's on seeded windows; greedy slots equal to one-shot
``generate`` on bf16-layout (fp32 here) pools and to the plain int8 batcher
on int8 pools; a round whose proposals are the true continuation accepts
all m, as JAX's does; penalized slots ride along at a = 0; the admission
headroom gives JAX's ``rejected_too_long``; and a round after a rejection
equals the same round on a cache that never held the rejected rows."""

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_serving_params import (  # noqa: F401 (one_thread: autouse)
    EOS,
    one_thread,
    serving_engines,
)

from visionselector_tpu.models.qwen25vl import continuous as jcont
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu_torch.models.qwen25vl import continuous as tcont
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl import model as tmodel

TIMEOUT = 120  # seconds per submit


@pytest.fixture(scope="module")
def w():
    return serving_engines()


def _image(w, q):
    return dict(input_ids=w["ids_for"](list(q)), pixel_values=w["px"],
                grid_thw=w["grid"])


def _serve(eng, reqs, **kw):
    """Submit (request, max_new, sampling kwargs) tuples from a thread
    each; returns (results, stats)."""
    bat = tcont.ContinuousBatcher(eng, **kw)
    try:
        with cf.ThreadPoolExecutor(max_workers=len(reqs)) as ex:
            futs = [ex.submit(bat.submit, r, m, EOS, **s)
                    for r, m, s in reqs]
            return [f.result(timeout=TIMEOUT) for f in futs], bat.stats
    finally:
        bat.shutdown()


@pytest.mark.parametrize("n, m, c", [(3, 4, 32), (2, 3, 16), (1, 5, 24)])
def test_lookup_props_matches_jax(n, m, c):
    """Seeded windows of a small alphabet (frequent repeats), -1-padded
    short contexts, a window of padding only and one with no match."""
    rng = np.random.RandomState(c + n)
    rows = []
    for _ in range(24):
        ctx = rng.randint(0, 5, size=rng.randint(1, c + 1))
        row = np.full(c, -1, np.int64)
        row[c - len(ctx):] = ctx
        rows.append(row)
    rows.append(np.full(c, -1, np.int64))
    rows.append(np.arange(c, dtype=np.int64))  # no repeat, no match
    buf = np.stack(rows)
    want = np.asarray(jcont._lookup_props(jnp.asarray(buf, jnp.int32), n, m))
    got = tcont._lookup_props(torch.from_numpy(buf), n, m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_speculative_slots_match_oracle(w, kv_quant):
    """More requests than slots, images and text: greedy speculative slots
    equal one-shot ``generate`` (the bf16-layout pool) and the plain
    batcher on an int8 pool (whose rounding one-shot decode has not),
    with the speculative path taken and counted per request."""
    eng = w["tsel"]
    reqs = [(_image(w, [8, 9]), 10, {}),
            (dict(input_ids=np.asarray([7, 8, 9, 7, 8, 9, 7, 8])), 8, {}),
            (_image(w, [50, 51]), 12, {}),
            (dict(input_ids=np.arange(40, 46)), 5, {})]
    kw = dict(n_slots=2, t_max=256, chunk=4, kv_quant=kv_quant)
    if kv_quant is None:
        want = [eng.generate(**r, max_new_tokens=m, eos_token_ids=EOS,
                             **s).tokens for r, m, s in reqs]
    else:
        want = [r.tokens for r in _serve(eng, reqs, **kw)[0]]
    results, stats = _serve(eng, reqs, speculative=3, **kw)
    for i, (res, tokens) in enumerate(zip(results, want)):
        assert res.tokens == tokens, (i, res.tokens, tokens)
        # m per round, up to the round the slot finished in
        assert res.spec_proposed % 3 == 0
        assert 3 * 4 * (res.decode_dispatches - 1) < res.spec_proposed \
            <= 3 * 4 * res.decode_dispatches
        assert 0 <= res.spec_accepted <= res.spec_proposed
    assert stats["spec_steps"] == 4 * stats["chunks"]
    assert stats["spec_tokens"] == sum(len(t) - 1 for t in want)
    assert stats["spec_proposed"] == sum(r.spec_proposed for r in results)


def _two_slot_pools(cache, rows=16):
    """A prefill cache as slot 0 of a 2-slot pool with ``rows`` more rows,
    in both packages."""
    def pool(x):
        x = torch.cat([x, torch.zeros_like(x[:, :, :rows])], 2)
        return torch.cat([x, torch.zeros_like(x)], 1)

    t_pool = tlm.KVCache(
        k=pool(cache.k), v=pool(cache.v),
        length=torch.cat([cache.length, torch.zeros_like(cache.length)], 1))
    j_pool = jlm.KVCache(*(jnp.asarray(x.numpy()) for x in (
        t_pool.k, t_pool.v, t_pool.length.int())))
    return t_pool, j_pool


def _true_continuation_window(state, want, m, c):
    """A window whose final 3-gram occurred earlier, followed by the
    plain decode's next m tokens, so the lookup proposes them."""
    tail = [97, 98, state.next_token]
    row = [-1] * (c - 2 * len(tail) - m) + tail + want[1:1 + m] + tail
    return np.asarray([row, [-1] * c], np.int64)


def test_spec_round_accepts_true_continuation(w):
    """One round over a 2-slot pool (slot 1 dead): the live slot accepts
    all m and emits the plain decode's next m + 1 tokens, its length
    grows by m + 1, the dead slot consumes nothing: equal to JAX's
    ``_spec_scan_slots`` on the same inputs."""
    eng, jeng = w["tsel"], w["jsel"]
    req = _image(w, [8, 9])
    m, c = 4, 32
    want = eng.generate(**req, max_new_tokens=8, eos_token_ids=EOS).tokens
    ts = eng.generate(**req, max_new_tokens=8, eos_token_ids=EOS,
                      _defer_decode=True)
    t_pool, j_pool = _two_slot_pools(ts.cache)
    len0 = t_pool.length.clone()
    buf = _true_continuation_window(ts, want, m, c)
    cur = np.asarray([ts.next_token, 0])
    pos = np.asarray([ts.start_pos, 0])
    live = np.asarray([True, False])
    em, acc, cache = tcont._spec_rounds(
        eng.params, t_pool, torch.from_numpy(cur), torch.from_numpy(pos),
        torch.from_numpy(live), torch.from_numpy(buf), m, 1, 3)
    z = jnp.zeros((2,), jnp.float32)
    jem, jacc, jcache, *_ = jcont._spec_scan_slots(
        jeng.params, j_pool, jnp.asarray(cur, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(live),
        jnp.asarray(buf, jnp.int32), z, z + 1, jnp.zeros((2,), jnp.int32),
        jnp.zeros((2, 2), jnp.uint32),
        jnp.zeros((2, eng.cfg.text.vocab_size), jnp.bool_), z + 1,
        jeng.cfg, m, 1, 3)
    assert acc.tolist() == [[m, -1]] == np.asarray(jacc).tolist()
    assert em[0, 0].tolist() == want[1:2 + m] == np.asarray(jem)[0, 0].tolist()
    np.testing.assert_array_equal(cache.length.numpy(),
                                  np.asarray(jcache.length))
    assert cache.length[:, 0].tolist() == (len0[:, 0] + m + 1).tolist()
    assert cache.length[:, 1].tolist() == len0[:, 1].tolist()


def test_penalized_and_sampled_slots_ride_along(w):
    """A penalized slot rides the speculative rounds at a = 0 and equals
    its one-shot penalized rollout (its proposals are not counted); the
    greedy neighbour equals its oracle; a sampled slot repeats under its
    seed whatever shares the pool."""
    eng = w["tsel"]
    pen = (_image(w, [8, 9]), 8, dict(repetition_penalty=1.4))
    greedy = (_image(w, [40, 41]), 8, {})
    sampled = (_image(w, [60, 61]), 8, dict(temperature=0.7, top_p=0.9,
                                            seed=7))
    want = [eng.generate(**r, max_new_tokens=m, eos_token_ids=EOS,
                         **s).tokens for r, m, s in (pen, greedy)]
    kw = dict(n_slots=3, t_max=256, chunk=4, speculative=3)
    (rp, rg, rs), stats = _serve(eng, [pen, greedy, sampled], **kw)
    assert [rp.tokens, rg.tokens] == want
    assert rp.spec_proposed == 0 and rp.spec_accepted == 0
    assert stats["spec_steps"] > 0
    (rs2,), _ = _serve(eng, [sampled], **kw)
    assert rs2.tokens == rs.tokens and len(rs.tokens) == 8


def test_headroom_rejects_like_jax(w):
    """A request that fits a plain pool but not chunk x (m + 1) rows of
    speculative headroom is served one-shot, counted in
    ``rejected_too_long`` as in JAX's batcher; a plain batcher of the same
    size admits it."""
    req = _image(w, [8, 9])
    state = w["tsel"].generate(**req, max_new_tokens=6, eos_token_ids=EOS,
                               _defer_decode=True)
    t_max = int(state.cache.length.max()) + 6 + 8
    want = w["tsel"].generate(**req, max_new_tokens=6,
                              eos_token_ids=EOS).tokens
    counts = []
    for m in (0, 3):
        (res,), stats = _serve(w["tsel"], [(req, 6, {})], n_slots=2,
                               t_max=t_max, chunk=4, speculative=m)
        assert res.tokens == want
        counts.append(stats["rejected_too_long"])
    jb = jcont.ContinuousBatcher(w["jsel"], n_slots=2, t_max=t_max, chunk=4,
                                 speculative=3)
    try:
        jb.submit(req, 6, EOS)
    finally:
        jb.shutdown()
    assert counts == [0, jb.stats["rejected_too_long"]] == [0, 1]


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_round_after_rejection_equals_a_fresh_cache(w, kv_quant):
    """Round 1 proposes wrong tokens (a = 0): m rejected rows stay in the
    pool above the new length. Round 2's verify logits and tokens equal
    the same round on a copy of the pool with those rows zeroed."""
    eng = w["tsel"]
    req = _image(w, [8, 9])
    m, c = 4, 32
    ts = eng.generate(**req, max_new_tokens=8, eos_token_ids=EOS,
                      _defer_decode=True)
    pool = tcont._insert_slot(
        tlm.init_kv_cache(eng.cfg.text, 2, 128, "cpu", torch.float32,
                          quant=kv_quant or False),
        ts.cache.k, ts.cache.v, ts.cache.length, 0)
    want = eng.generate(**req, max_new_tokens=8, eos_token_ids=EOS).tokens
    wrong = np.asarray([[3, 4, 5, 3, 4, 5] + [3] * (c - 6), [-1] * c])
    live = torch.tensor([True, False])
    em, acc, pool = tcont._spec_rounds(
        eng.params, pool, torch.tensor([ts.next_token, 0]),
        torch.tensor([ts.start_pos, 0]), live, torch.from_numpy(wrong), m,
        1, 3)
    assert acc[0, 0] == 0 and em[0, 0, 0] == want[1]
    base = int(pool.length[0, 0])
    fresh = tlm.QuantKVCache(**{f: getattr(pool, f).clone() for f in (
        "k", "v", "k_scale", "v_scale", "length")}) if kv_quant else \
        tlm.KVCache(k=pool.k.clone(), v=pool.v.clone(),
                    length=pool.length.clone())
    held = 0
    for name in ("k", "v", "k_scale", "v_scale")[:4 if kv_quant else 2]:
        rows = getattr(fresh, name)[:, 0, base:]
        held += int(rows.abs().sum() > 0)
        rows.zero_()
    assert held  # the rejected rows were there
    cur = torch.tensor([want[1], 0])
    pos = torch.tensor([ts.start_pos + 1, 0])
    props = torch.tensor([want[2:2 + m], [0] * m])
    out = [tmodel._verify_logits(eng.params, p, cur, props, pos)[0]
           for p in (pool, fresh)]
    assert torch.equal(out[0], out[1])
    if kv_quant is None:  # a quantized pool's tokens drift from one-shot's
        assert out[0][0].argmax(-1).tolist() == want[2:3 + m]
