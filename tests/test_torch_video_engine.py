"""Video, several-image and image + video requests through the port's
engine against the JAX package's, on qwen25vl_tiny with a 4-layer decoder
(FastV's target layer 2 lies inside it) and the same weights
(``from_jax_params``; the decoder's matrices x8 so greedy tokens vary, the
scorer at std 0.02 so top-k gaps exceed fp32 noise). Clips are a few
frames of 56x84 (grid (2, 4, 6)); the JAX side runs as its own tests run
it on the CPU.

Selected indices must be bit-equal, first-token logits and log-likelihoods
within 1e-4 (fp32), greedy tokens and greedy flags equal. The port's own
paths (``generate_batch``, ``start_chunked_prefill``, the batcher) must
give one-shot ``generate``'s tokens. The prefix store shows the one
deliberate difference from the reference: two clips never share an
entry."""

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_serving_params import (  # noqa: F401 (one_thread: autouse)
    EOS,
    four_layers,
    one_thread,
    run_chunked,
    serving_tree,
)

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.preprocess.image import (
    preprocess_image,
    preprocess_video_frames,
)
from visionselector_tpu.selector import baselines as jbase
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.continuous import (
    ContinuousBatcher,
)
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.selector import baselines as tbase

NEW_TOKENS = 6
ATOL = 1e-4
TIMEOUT = 120  # seconds per batcher submit
CFG = jax_tiny()


def _frames(t, hw, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(t, *hw, 3) * 255).astype(np.uint8)


def _clip(t=4, seed=1):
    return preprocess_video_frames(_frames(t, (56, 84), seed), min_pixels=1,
                                   max_pixels=10**9)


def _image(hw, seed):
    return preprocess_image(_frames(1, hw, seed)[0], min_pixels=1,
                            max_pixels=10**9)


def _block(grid, token):
    """The vision tokens of each grid row, between start and end ids."""
    ids = []
    for t, h, w in np.asarray(grid):
        ids += ([CFG.vision_start_token_id] + [token] * (int(t * h * w) // 4)
                + [CFG.vision_end_token_id])
    return ids


def _requests():
    """generate() kwargs by name: a clip, two images, an image then a clip,
    and a clip before an image (pixel rows still image first)."""
    vpx, vgrid = _clip()
    apx, agrid = _image((56, 84), 2)
    bpx, bgrid = _image((56, 56), 3)
    video = dict(pixel_values_videos=vpx, video_grid_thw=vgrid,
                 second_per_grid_ts=np.array([1.0]))
    vid, img = CFG.video_token_id, CFG.image_token_id
    return {
        "video": dict(input_ids=np.asarray(
            [100, 200] + _block(vgrid, vid) + [300, 400, 500]), **video),
        "two_images": dict(
            input_ids=np.asarray([100] + _block(agrid, img) + [200]
                                 + _block(bgrid, img) + [300, 400]),
            pixel_values=np.concatenate([apx, bpx]),
            grid_thw=np.concatenate([agrid, bgrid])),
        "mixed": dict(
            input_ids=np.asarray([100] + _block(agrid, img)
                                 + _block(vgrid, vid) + [300, 400]),
            pixel_values=apx, grid_thw=agrid, **video),
        "video_first": dict(
            input_ids=np.asarray([100] + _block(vgrid, vid) + [200]
                                 + _block(bgrid, img) + [300]),
            pixel_values=bpx, grid_thw=bgrid,
            **dict(video, second_per_grid_ts=np.array([0.5]))),
    }


@pytest.fixture(scope="module")
def w():
    jcfg = four_layers(jax_tiny())
    tcfg = four_layers(qwen25vl_tiny())
    tree = serving_tree(jcfg, seed=0, scorer_std=0.02)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = from_jax_params(tree, tcfg, "cpu")

    def engines(strategy=None, **kw):
        """Both engines; ``strategy``: a baseline's name and keywords."""
        js = ts = None
        if strategy is not None:
            js = jbase.get_baseline(strategy[0], **strategy[1])
            ts = tbase.get_baseline(strategy[0], **strategy[1])
            kw["use_selector"] = False
        return (jmodel.QwenVLEngine(jcfg, jparams, strategy=js, **kw),
                tmodel.QwenVLEngine(tcfg, tparams, device="cpu",
                                    strategy=ts, **kw))

    return dict(engines=engines, req=_requests())


def _jax_generate(jeng, req):
    """The JAX engine's prefill state, its first-token logits and cache
    lengths (read before the decode loop donates the cache) and its greedy
    tokens."""
    state = jeng.generate(**req, max_new_tokens=NEW_TOKENS,
                          _defer_decode=True)
    logits = np.asarray(state.logits)
    lengths = np.asarray(state.cache.length)
    tokens = jmodel._run_decode_loop(
        jeng.params, jeng.cfg, state.cache, jnp.asarray(state.next_token),
        state.start_pos, (jeng.cfg.eos_token_id,), NEW_TOKENS)
    return state, (logits, lengths), [int(t) for t in tokens]


@pytest.mark.parametrize("name, budget", [
    ("video", 0.1), ("video", None), ("two_images", 0.5), ("mixed", 0.5),
    ("mixed", None), ("video_first", 0.5)])
def test_generate_matches_jax(w, name, budget):
    """Selector (``budget``) or ``orig`` (None): the kept set, the
    compacted length, the decode start, first-token logits and greedy
    tokens equal the JAX engine's."""
    kw = (dict(use_selector=False) if budget is None else
          dict(use_selector=True, budget=budget))
    jeng, teng = w["engines"](**kw)
    req = w["req"][name]
    want, (want_logits, _), want_tokens = _jax_generate(jeng, req)
    state = teng.generate(**req, max_new_tokens=NEW_TOKENS,
                          _defer_decode=True)
    got = state.result
    assert got.num_vision_tokens == want.result.num_vision_tokens
    assert got.prefill_len == want.result.prefill_len
    assert state.start_pos == want.start_pos
    if budget is None:
        assert got.selected_indices is None
    else:
        k = max(1, int(got.num_vision_tokens * budget))
        assert len(got.selected_indices) == k
        np.testing.assert_array_equal(got.selected_indices,
                                      want.result.selected_indices)
    np.testing.assert_allclose(state.logits.numpy(), want_logits,
                               atol=ATOL, rtol=0)
    res = teng.generate(**req, max_new_tokens=NEW_TOKENS)
    assert res.tokens == want_tokens and len(set(res.tokens)) > 1


@pytest.mark.parametrize("name, use_selector", [("video", True),
                                                ("mixed", False)])
def test_loglikelihood_and_choices_match_jax(w, name, use_selector):
    jeng, teng = w["engines"](use_selector=use_selector, budget=0.5)
    req = dict(w["req"][name])
    ids = req.pop("input_ids")
    for cont in ([7, 8, 9], [11]):
        got = teng.loglikelihood(ids, np.asarray(cont), **req)
        want = jeng.loglikelihood(ids, np.asarray(cont), **req)
        assert abs(got[0] - want[0]) <= ATOL and got[1] == want[1]
    choices = [np.asarray(c) for c in ([7, 8], [11], [12, 13, 14])]
    got = tmodel.run_loglikelihood_choices(teng, ids, choices, **req)
    want = jmodel.run_loglikelihood_choices(jeng, ids, choices, **req)
    for (g, gg), (x, xg) in zip(got, want):
        assert abs(g - x) <= ATOL and gg == xg


def test_generate_batch_equals_one_shot(w):
    _, teng = w["engines"](use_selector=True, budget=0.5)
    reqs = [w["req"][n] for n in ("video", "two_images", "mixed")]
    got = teng.generate_batch(reqs, max_new_tokens=NEW_TOKENS,
                              eos_token_ids=EOS)
    for res, req in zip(got, reqs):
        assert res.tokens == teng.generate(**req, max_new_tokens=NEW_TOKENS,
                                           eos_token_ids=EOS).tokens


@pytest.mark.parametrize("name", ["video", "mixed"])
def test_chunked_prefill_and_batcher_equal_one_shot(w, name):
    """``start_chunked_prefill`` (the tower in 2 groups, 8-row segments)
    gives the one-shot prefill's first token and decode start; the batcher
    with chunked admission gives one-shot ``generate``'s tokens."""
    _, teng = w["engines"](use_selector=True, budget=0.5)
    req = w["req"][name]
    fused = teng.generate(**req, max_new_tokens=NEW_TOKENS,
                          eos_token_ids=EOS, _defer_decode=True)
    got, _ = run_chunked(teng.start_chunked_prefill(
        **req, max_new_tokens=NEW_TOKENS, eos_token_ids=EOS,
        prefill_chunk=8, vit_segments=2))
    assert (got.next_token, got.start_pos) == (fused.next_token,
                                               fused.start_pos)
    np.testing.assert_array_equal(got.result.selected_indices,
                                  fused.result.selected_indices)
    bat = ContinuousBatcher(teng, n_slots=2, t_max=256, chunk=2,
                            prefill_chunk=8, prefill_vit_segments=2)
    try:
        with cf.ThreadPoolExecutor(max_workers=2) as ex:
            futs = [ex.submit(bat.submit, req, NEW_TOKENS, EOS)
                    for _ in range(2)]
            results = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        bat.shutdown()
    want = teng.generate(**req, max_new_tokens=NEW_TOKENS,
                         eos_token_ids=EOS).tokens
    assert all(r.tokens == want for r in results)
    assert bat.stats["chunked_admissions"] == 2


@pytest.mark.parametrize("name", ["visionzip", "fastv"])
def test_strategy_on_a_video_matches_jax(w, name):
    kw = {"target_layer": 2} if name == "fastv" else {}
    jeng, teng = w["engines"](budget=0.5, strategy=(name, kw))
    req = w["req"]["video"]
    want, (want_logits, want_lengths), want_tokens = _jax_generate(jeng,
                                                                   req)
    state = teng.generate(**req, max_new_tokens=NEW_TOKENS,
                          _defer_decode=True)
    np.testing.assert_array_equal(state.result.selected_indices,
                                  want.result.selected_indices)
    assert state.result.prefill_len == want.result.prefill_len
    np.testing.assert_array_equal(state.cache.length.numpy(), want_lengths)
    np.testing.assert_allclose(state.logits.numpy(), want_logits, atol=ATOL,
                               rtol=0)
    assert teng.generate(**req, max_new_tokens=NEW_TOKENS).tokens == \
        want_tokens


def test_prefix_store_never_shares_a_clip(w):
    """Two clips with the same grid and the same question: the JAX store
    hits on the second (its signature hashes image pixels only, and
    ``<|video_pad|>`` ids are equal across clips), so its state carries the
    first clip's vision k/v; the port's store misses, and its state equals
    a fresh prefill of the second clip."""
    jeng, teng = w["engines"](use_selector=False)
    first = w["req"]["video"]
    vpx, vgrid = _clip(seed=9)
    second = dict(first, pixel_values_videos=vpx, video_grid_thw=vgrid)
    jstore = jmodel.PrefixCacheStore(min_prefix=1)
    tstore = tmodel.PrefixCacheStore(min_prefix=1)
    for req in (first, second):
        jstate = jmodel.prefix_cached_prefill(jeng, jstore, **req,
                                              max_new_tokens=4)
        tstate = tmodel.prefix_cached_prefill(teng, tstore, **req,
                                              max_new_tokens=4)
    assert (jstore.hits, jstore.misses) == (1, 1)
    assert (tstore.hits, tstore.misses) == (0, 2)
    fresh = teng.generate(**second, max_new_tokens=4, _defer_decode=True)
    n = int(fresh.cache.length[0, 0])
    np.testing.assert_allclose(tstate.cache.k[:, :, :n].numpy(),
                               fresh.cache.k[:, :, :n].numpy(), atol=0,
                               rtol=0)
    vis = second["input_ids"] == CFG.video_token_id
    stale = np.abs(np.asarray(jstate.cache.k)[:, :, :n][:, :, vis]
                   - fresh.cache.k[:, :, :n][:, :, vis].numpy()).max()
    assert stale > 100 * ATOL, stale


def test_vision_input_checks(w):
    _, teng = w["engines"](use_selector=True, budget=0.5)
    req = w["req"]["mixed"]
    with pytest.raises(ValueError, match="without video_grid_thw"):
        teng.generate(**dict(req, video_grid_thw=None), max_new_tokens=2)
    with pytest.raises(ValueError, match="without grid_thw"):
        teng.loglikelihood(req["input_ids"], [5],
                           pixel_values=req["pixel_values"])
    # a clip's <|video_pad|> ids with its rows given as an image's
    vreq = w["req"]["video"]
    with pytest.raises(ValueError, match="merged vision tokens"):
        teng.generate(vreq["input_ids"], vreq["pixel_values_videos"],
                      vreq["video_grid_thw"], max_new_tokens=2)
