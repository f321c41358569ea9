"""The port's serving paths against the JAX package's on qwen25vl_tiny (CPU,
fp32; the JAX side as its own tests run it, ``VST_ATTN_IMPL=xla`` from
conftest): streaming, decode-batched generation, chat sessions and the
prefix cache (``tests/test_prefix_cache.py``'s cases on the port), and that
none of them builds an autograd graph. The segmented tower, chunked
admission and the batcher's new options are in
``test_torch_chunked_admission.py``.

Both packages get the same numpy weights (``torch_serving_params``) and
the same requests. Greedy tokens must be equal. Paths whose JAX
counterpart draws other random numbers (sampling) are held to the port's
own one-shot rollout."""

import numpy as np
import pytest
import torch
from torch_serving_params import (  # noqa: F401 (one_thread: autouse)
    EOS,
    batch_requests,
    one_thread,
    request,
    run_chunked,
    serving_engines,
    stream,
)

from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.preprocess.image import preprocess_image

ATOL = 1e-5


@pytest.fixture(scope="module")
def w():
    return serving_engines()


# -- streaming ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["selector", "orig", "text"])
def test_stream_chunks_match_jax(w, kind):
    """The first token alone, then chunks of up to 8: boundaries and tokens
    equal the JAX engine's, and their concatenation is the non-streamed
    rollout."""
    req, e = request(w, kind)
    want, _ = stream(w["j" + e], req, max_new_tokens=20, eos_token_ids=EOS)
    got, toks = stream(w["t" + e], req, max_new_tokens=20,
                        eos_token_ids=EOS)
    assert got == want
    assert [len(c) for c in got] == [1, 8, 8, 3]
    assert sum(got, []) == toks == w["t" + e].generate(
        **req, max_new_tokens=20, eos_token_ids=EOS).tokens
    assert len(set(toks)) > 3  # the weights give varied tokens


@pytest.mark.parametrize("at", [0, 5, 9])
def test_stream_eos_mid_chunk_and_first(w, at):
    """An EOS at token ``at`` (the first token, mid-chunk, or opening a
    chunk after a full one) ends the stream as in the JAX engine: the chunk
    it cuts is delivered without it (empty when it opens the chunk)."""
    req, _ = request(w, "selector")
    full = w["tsel"].generate(**req, max_new_tokens=20,
                              eos_token_ids=EOS).tokens
    at = full.index(full[at])  # its first occurrence
    eos = (full[at],)
    want, _ = stream(w["jsel"], req, max_new_tokens=20, eos_token_ids=eos)
    got, toks = stream(w["tsel"], req, max_new_tokens=20, eos_token_ids=eos)
    assert got == want
    assert toks == full[:at] == sum(got, [])
    assert got[-1] == ([] if at == 0 else full[1 + 8 * ((at - 1) // 8):at])


def test_stream_one_token_and_sampled(w):
    """max_new_tokens 1 streams one chunk; a sampled stream equals the
    port's own non-streamed sampled rollout for the same seed (the port's
    generator continues across chunks; the reference splits its key per
    chunk)."""
    req, _ = request(w, "selector")
    want, _ = stream(w["jsel"], req, max_new_tokens=1, eos_token_ids=EOS)
    got, _ = stream(w["tsel"], req, max_new_tokens=1, eos_token_ids=EOS)
    assert got == want and len(got) == 1 and len(got[0]) == 1
    samp = dict(temperature=0.8, top_p=0.9, top_k=40, seed=3,
                max_new_tokens=20, eos_token_ids=EOS)
    chunks, toks = stream(w["tsel"], req, **samp)
    assert sum(chunks, []) == toks == w["tsel"].generate(**req, **samp).tokens
    assert toks != w["tsel"].generate(**req, max_new_tokens=20,
                                      eos_token_ids=EOS).tokens


# -- decode-batched generation -------------------------------------------------


def test_generate_batch_matches_jax_and_own_generate(w):
    """Image and text-only requests in one batch: tokens equal the JAX
    engine's ``generate_batch`` and each row its own ``generate``, with
    the prefill metadata of its own request."""
    reqs = batch_requests(w)
    want = w["jsel"].generate_batch(reqs, max_new_tokens=10,
                                    eos_token_ids=EOS)
    got = w["tsel"].generate_batch(reqs, max_new_tokens=10,
                                   eos_token_ids=EOS)
    for g, jw, r in zip(got, want, reqs):
        own = w["tsel"].generate(**r, max_new_tokens=10, eos_token_ids=EOS)
        assert g.tokens == [int(t) for t in jw.tokens] == own.tokens
        assert g.prefill_len == jw.prefill_len == own.prefill_len
        if own.selected_indices is None:
            assert g.selected_indices is None
        else:
            np.testing.assert_array_equal(g.selected_indices,
                                          own.selected_indices)


def test_generate_batch_fastv_per_layer_lengths(w):
    """A FastV engine's caches (layers [0, 2) at the whole sequence, the
    rest at the kept one) batch with a text-only request: each row equals
    its own ``generate`` and the JAX engine's ``generate_batch``."""
    reqs = [request(w, "selector")[0], request(w, "text")[0]]
    state = w["tfastv"].generate(**reqs[0], max_new_tokens=8,
                                 eos_token_ids=EOS, _defer_decode=True)
    lens = state.cache.length[:, 0].tolist()
    assert lens[0] == lens[1] != lens[2] == lens[3]
    want = w["jfastv"].generate_batch(reqs, max_new_tokens=8,
                                      eos_token_ids=EOS)
    got = w["tfastv"].generate_batch(reqs, max_new_tokens=8,
                                     eos_token_ids=EOS)
    for g, jw, r in zip(got, want, reqs):
        own = w["tfastv"].generate(**r, max_new_tokens=8, eos_token_ids=EOS)
        assert g.tokens == [int(t) for t in jw.tokens] == own.tokens


def test_generate_batch_eos_one_token_penalty_and_sampling(w):
    """Per-row early EOS (rows freeze while others step), max_new_tokens 1,
    a repetition penalty and sampling: each row equals its own
    ``generate`` with the same settings. Sampling takes top_k 20: over the
    whole vocabulary, the sorted order of near-tied tail tokens (and so
    the noise each gets) flips on the ~1e-5 logit differences between a
    batched and a one-row decoder GEMM."""
    eng = w["tsel"]
    reqs = batch_requests(w)
    base = [eng.generate(**r, max_new_tokens=6, eos_token_ids=EOS).tokens
            for r in reqs]
    eos = (base[0][2],)  # request 0 stops early, the others may not
    cases = [dict(max_new_tokens=6, eos_token_ids=eos),
             dict(max_new_tokens=1, eos_token_ids=EOS),
             dict(max_new_tokens=8, eos_token_ids=EOS,
                  repetition_penalty=1.5),
             dict(max_new_tokens=8, eos_token_ids=EOS, temperature=0.8,
                  top_p=0.9, top_k=20, seed=5)]
    for kw in cases:
        got = eng.generate_batch(reqs, **kw)
        want = [eng.generate(**r, **kw).tokens for r in reqs]
        assert [g.tokens for g in got] == want, kw
    assert len(eng.generate_batch(reqs, max_new_tokens=6,
                                  eos_token_ids=eos)[0].tokens) < 6


# -- chat sessions ----------------------------------------------------------------


def test_session_turns_match_jax(w):
    """First, second and third turns equal the JAX sessions' (selector);
    under ``orig`` the second turn equals a fresh prefill of the
    concatenated stream. (Under compression it need not: decode numbers the
    answer's rows from the compacted length, a fresh prefill from their
    index in the stream.)"""
    ids = w["ids_for"]([8, 9])
    px, grid = w["px"], w["grid"]
    turns = (np.array([41, 42, 43]), np.array([77]))
    outs = {}
    for pkg, eng in (("jax", w["jsel"]), ("port", w["tsel"])):
        mod = jmodel if pkg == "jax" else tmodel
        r1, sess = mod.start_chat_session(eng, ids, px, grid,
                                          max_new_tokens=5, eos_token_ids=EOS)
        r2, sess2 = mod.continue_chat_session(eng, sess, turns[0],
                                              max_new_tokens=5)
        r3, sess3 = mod.continue_chat_session(eng, sess2, turns[1],
                                              max_new_tokens=5)
        outs[pkg] = ([list(map(int, r.tokens)) for r in (r1, r2, r3)],
                     [s.pos for s in (sess, sess2, sess3)])
    assert outs["port"] == outs["jax"]
    assert outs["port"][0][0] == w["tsel"].generate(
        ids, px, grid, max_new_tokens=5, eos_token_ids=EOS).tokens
    eng = w["torig"]
    r1, sess = tmodel.start_chat_session(eng, ids, px, grid,
                                         max_new_tokens=5, eos_token_ids=EOS)
    r2, _ = tmodel.continue_chat_session(eng, sess, turns[0],
                                         max_new_tokens=5)
    full = np.concatenate([ids, r1.tokens, turns[0]]).astype(np.int64)
    assert r2.tokens == eng.generate(full, px, grid, max_new_tokens=5,
                                     eos_token_ids=EOS).tokens


def test_older_session_unchanged_and_capacity_growth(w):
    """A newer turn never writes into an older session's cache: turn 2
    again from the first session gives the same tokens after another
    branch ran. A follow-up that needs more rows than the first turn's
    cache holds grows into a new buffer and still equals a fresh prefill
    (``orig``)."""
    ids, px, grid = w["ids_for"]([8, 9]), w["px"], w["grid"]
    eng = w["torig"]
    r1, sess = tmodel.start_chat_session(eng, ids, px, grid,
                                         max_new_tokens=3, eos_token_ids=EOS)
    k_before = sess.cache.k.clone()
    a, _ = tmodel.continue_chat_session(eng, sess, np.array([41, 42]),
                                        max_new_tokens=4)
    tmodel.continue_chat_session(eng, sess, np.array([60, 61, 62, 63]),
                                 max_new_tokens=4)
    again, _ = tmodel.continue_chat_session(eng, sess, np.array([41, 42]),
                                            max_new_tokens=4)
    assert again.tokens == a.tokens
    assert torch.equal(sess.cache.k, k_before)
    rows = sess.cache.k.shape[2]
    turn = np.arange(300, 300 + rows).astype(np.int64)  # past the capacity
    big, sess2 = tmodel.continue_chat_session(eng, sess, turn,
                                              max_new_tokens=6)
    assert sess2.cache.k.shape[2] > rows
    full = np.concatenate([ids, r1.tokens, turn]).astype(np.int64)
    assert big.tokens == eng.generate(full, px, grid, max_new_tokens=6,
                                      eos_token_ids=EOS).tokens


# -- prefix cache (tests/test_prefix_cache.py's cases on the port) -------------


def _cached(eng, store, ids, px=None, grid=None, n=6, **kw):
    return tmodel.generate_prefix_cached(eng, store, ids, px, grid,
                                         max_new_tokens=n, eos_token_ids=EOS,
                                         **kw)


def _fresh(eng, ids, px=None, grid=None, n=6, **kw):
    return eng.generate(ids, px, grid, max_new_tokens=n, eos_token_ids=EOS,
                        **kw)


def test_prefix_exact_repeat_hits(w):
    eng, px, grid = w["tsel"], w["px"], w["grid"]
    store = tmodel.PrefixCacheStore(min_prefix=1)
    ids = w["ids_for"]([8, 9, 10])
    ref = _fresh(eng, ids, px, grid).tokens
    assert _cached(eng, store, ids, px, grid).tokens == ref
    assert _cached(eng, store, ids, px, grid).tokens == ref
    assert (store.misses, store.hits) == (1, 1)


def test_prefix_different_question_matches_fresh_and_jax(w):
    """Same image and system prefix, another question: the hit equals a
    fresh prefill of the new prompt and the JAX store's hit."""
    px, grid = w["px"], w["grid"]
    ids_b = w["ids_for"]([8, 77, 78, 79])
    toks = {}
    for pkg in ("jax", "port"):
        mod, eng = ((jmodel, w["jsel"]) if pkg == "jax"
                    else (tmodel, w["tsel"]))
        store = mod.PrefixCacheStore(min_prefix=1)
        mod.generate_prefix_cached(eng, store, w["ids_for"]([8, 9, 10]), px,
                                   grid, max_new_tokens=5, eos_token_ids=EOS)
        r = mod.generate_prefix_cached(eng, store, ids_b, px, grid,
                                       max_new_tokens=5, eos_token_ids=EOS)
        assert store.hits == 1
        toks[pkg] = [int(t) for t in r.tokens]
        if pkg == "port":
            ref = _fresh(eng, ids_b, px, grid, n=5)
            assert r.num_vision_tokens == ref.num_vision_tokens
            np.testing.assert_array_equal(r.selected_indices,
                                          ref.selected_indices)
            assert toks[pkg] == ref.tokens
    assert toks["port"] == toks["jax"]


def test_prefix_snapshot_survives_repeated_hits(w):
    """Hits with different suffixes append into copies: the stored
    snapshot is unchanged, so every hit equals its fresh prefill."""
    eng, px, grid = w["tsel"], w["px"], w["grid"]
    store = tmodel.PrefixCacheStore(min_prefix=1)
    _cached(eng, store, w["ids_for"]([8, 9]), px, grid, n=4)
    snap = next(iter(store.entries.values())).cache
    k0, len0 = snap.k.clone(), snap.length.clone()
    for q in ([8, 50], [8, 51, 52], [8, 50]):
        ids = w["ids_for"](q)
        assert (_cached(eng, store, ids, px, grid, n=4).tokens
                == _fresh(eng, ids, px, grid, n=4).tokens), q
    assert store.hits == 3
    assert torch.equal(snap.k, k0) and torch.equal(snap.length, len0)


def test_prefix_misses_for_another_image_and_vision_divergence(w):
    eng, px, grid = w["tsel"], w["px"], w["grid"]
    store = tmodel.PrefixCacheStore(min_prefix=1)
    ids = w["ids_for"]([8, 9])
    _cached(eng, store, ids, px, grid, n=4)
    img2 = (np.random.RandomState(9).rand(56, 84, 3) * 255).astype(np.uint8)
    px2, grid2 = preprocess_image(img2)
    assert (_cached(eng, store, ids, px2, grid2, n=4).tokens
            == _fresh(eng, ids, px2, grid2, n=4).tokens)
    # same image, a different prefix before the vision span
    ids_b = w["ids_for"]([8, 9], before=(5, 99, 7))
    assert (_cached(eng, store, ids_b, px, grid, n=4).tokens
            == _fresh(eng, ids_b, px, grid, n=4).tokens)
    assert (store.hits, store.misses) == (0, 3)


def test_prefix_longer_budget_on_hit_and_sampled_hit(w):
    """A hit that wants more new tokens than the stored request grows the
    cache; a sampled hit equals the port's fresh sampled rollout."""
    eng, px, grid = w["tsel"], w["px"], w["grid"]
    store = tmodel.PrefixCacheStore(min_prefix=1)
    _cached(eng, store, w["ids_for"]([8, 9]), px, grid, n=3)
    ids_b = w["ids_for"]([8, 60])
    assert (_cached(eng, store, ids_b, px, grid, n=12).tokens
            == _fresh(eng, ids_b, px, grid, n=12).tokens)
    samp = dict(temperature=0.8, top_p=0.9, seed=5)
    ref = _fresh(eng, ids_b, px, grid, n=10, **samp).tokens
    assert ref != _fresh(eng, ids_b, px, grid, n=10).tokens
    assert _cached(eng, store, ids_b, px, grid, n=10, **samp).tokens == ref
    assert store.hits == 2


def test_prefix_text_only_reuse(w):
    eng = w["torig"]
    store = tmodel.PrefixCacheStore(min_prefix=1)
    base = list(range(40, 72))  # a shared 32-token system prompt
    _cached(eng, store, np.asarray(base + [7, 8]), n=4)
    ids_b = np.asarray(base + [9, 10, 11])
    assert _cached(eng, store, ids_b, n=4).tokens == _fresh(eng, ids_b,
                                                            n=4).tokens
    assert store.hits == 1


def test_prefix_fastv_exact_repeat_only(w):
    """FastV's selection depends on the question: only whole-prompt
    repeats hit (per-layer lengths roll back by one row each)."""
    eng, px, grid = w["tfastv"], w["px"], w["grid"]
    store = tmodel.PrefixCacheStore(min_prefix=1)
    ids = w["ids_for"]([8, 9, 10])
    ref = _fresh(eng, ids, px, grid, n=5).tokens
    assert _cached(eng, store, ids, px, grid, n=5).tokens == ref
    assert _cached(eng, store, ids, px, grid, n=5).tokens == ref
    assert store.hits == 1
    ids_b = w["ids_for"]([8, 9, 42])
    assert (_cached(eng, store, ids_b, px, grid, n=5).tokens
            == _fresh(eng, ids_b, px, grid, n=5).tokens)
    assert store.misses == 2


def _entry(ids, sig=None):
    return tmodel.PrefixEntry(sig=sig, ids=np.asarray(ids), vis_end=0,
                              cache=None, pos=len(ids), result=None)


def test_prefix_store_lru_min_prefix_duplicates():
    store = tmodel.PrefixCacheStore(max_entries=2, min_prefix=1)
    for t in (100, 200, 300):
        store.insert(_entry([t, 1, 2, 3]))
    assert [tuple(e.ids) for e in store.entries.values()] == [
        (200, 1, 2, 3), (300, 1, 2, 3)]
    gate = tmodel.PrefixCacheStore(min_prefix=8)
    gate.insert(_entry(np.arange(4)))
    assert gate.lookup(None, np.arange(4)) is None
    dup = tmodel.PrefixCacheStore(min_prefix=1)
    dup.insert(_entry(np.arange(8), "x"))
    dup.insert(_entry(np.arange(8), "x"))
    assert len(dup.entries) == 1
    e, consumed = dup.lookup("x", np.arange(10))
    assert consumed == 8 and dup.lookup("y", np.arange(10)) is None


# -- inference builds no autograd graph ----------------------------------


def test_serving_paths_build_no_graph(w):
    """With every parameter requiring grad (as after training), streaming,
    ``generate_batch``, a chunked admission, a session turn and a prefix
    hit return tensors without a ``grad_fn``: inference stays under
    ``no_grad`` in any calling thread."""
    eng = w["tsel"]
    flags = [p.requires_grad for p in eng.params.parameters()]
    ids, px, grid = w["ids_for"]([8, 9]), w["px"], w["grid"]
    try:
        for p in eng.params.parameters():
            p.requires_grad_(True)
        stream(eng, dict(input_ids=ids, pixel_values=px, grid_thw=grid),
                max_new_tokens=10, eos_token_ids=EOS)
        batch = eng.generate_batch(batch_requests(w), max_new_tokens=3,
                                   eos_token_ids=EOS, repetition_penalty=1.2)
        state, _ = run_chunked(eng.start_chunked_prefill(
            ids, px, grid, max_new_tokens=3, eos_token_ids=EOS,
            prefill_chunk=8, vit_segments=2))
        _, sess = tmodel.start_chat_session(eng, ids, px, grid,
                                            max_new_tokens=3,
                                            eos_token_ids=EOS)
        turn, sess2 = tmodel.continue_chat_session(eng, sess, [41, 42],
                                                   max_new_tokens=3)
        store = tmodel.PrefixCacheStore(min_prefix=1)
        tmodel.prefix_cached_prefill(eng, store, ids, px, grid,
                                     max_new_tokens=3, eos_token_ids=EOS)
        hit = tmodel.prefix_cached_prefill(eng, store, ids, px, grid,
                                           max_new_tokens=3,
                                           eos_token_ids=EOS)
    finally:
        for p, f in zip(eng.params.parameters(), flags):
            p.requires_grad_(f)
    assert store.hits == 1
    tensors = [state.logits, state.cache.k, sess.cache.k, sess2.cache.k,
               turn.logits, hit.logits, hit.cache.k]
    tensors += [r.logits for r in batch]
    assert all(t.grad_fn is None for t in tensors)
