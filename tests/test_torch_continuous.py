"""The port's continuous batcher on qwen25vl_tiny (CPU, fp32): requests
join and leave a shared slot pool mid-flight, and every result equals the
port's own one-shot ``generate`` of the same request — greedy, sampled with
the same seed (each slot draws from its own generator), and with a
repetition penalty. An int8 pool gives the same tokens through the decode
kernel's plain version (the default on CPU tensors) and through the dense
``decode_attn="plain"`` path."""

import concurrent.futures as cf

import numpy as np
import pytest
import torch

from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl.continuous import (
    ContinuousBatcher,
)
from visionselector_tpu_torch.models.qwen25vl.model import (
    QwenVLEngine,
    init_params,
)
from visionselector_tpu_torch.preprocess.image import preprocess_image
from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

TIMEOUT = 120  # seconds per submit


@pytest.fixture(scope="module")
def setup():
    cfg = qwen25vl_tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = QwenVLEngine(cfg, params, use_selector=True, budget=0.5,
                       device="cpu")
    img = (np.random.RandomState(0).rand(56, 84, 3) * 255).astype(np.uint8)
    pixels, grid = preprocess_image(img)

    def image_req(q):
        ids = expand_vision_tokens([5, 6, 7], list(q), grid)
        return dict(input_ids=ids, pixel_values=pixels, grid_thw=grid)

    def text_req(q):
        return dict(input_ids=np.asarray(q, np.int64))

    return eng, image_req, text_req


def _serve(eng, reqs, **kw):
    """Submit (request, max_new, sampling kwargs) tuples from one thread
    each; returns (results, stats)."""
    bat = ContinuousBatcher(eng, **kw)
    try:
        with cf.ThreadPoolExecutor(max_workers=len(reqs)) as ex:
            futs = [ex.submit(bat.submit, r, m, (-1,), **s)
                    for r, m, s in reqs]
            results = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        bat.shutdown()
    return results, bat.stats


def _oneshot(eng, reqs):
    return [eng.generate(**r, max_new_tokens=m, eos_token_ids=(-1,),
                         **s).tokens for r, m, s in reqs]


def test_mixed_requests_match_oneshot(setup):
    """More requests than slots, image and text-only, different budgets:
    every result equals the one-shot one, slots get reused and a request
    joins while others are mid-decode."""
    eng, image_req, text_req = setup
    reqs = [(image_req([8, 9]), 12, {}), (image_req([8, 40, 41]), 5, {}),
            (text_req([7, 8, 9, 10]), 9, {}), (image_req([50]), 16, {}),
            (text_req([30, 31]), 3, {})]
    want = _oneshot(eng, reqs)
    results, stats = _serve(eng, reqs, n_slots=2, t_max=256, chunk=4)
    for i, (res, w) in enumerate(zip(results, want)):
        assert res.tokens == w, (i, res.tokens, w)
        assert res.first_token_seconds > 0 and res.decode_dispatches >= 1
    assert stats["admitted"] == len(reqs)
    assert stats["max_concurrent"] == 2
    assert stats["mid_flight_joins"] >= 1
    assert stats["chunks"] >= 3 and stats["rejected_too_long"] == 0


def test_sampled_and_penalized_slots_match_oneshot(setup):
    """Sampled slots (own seeds), a penalized greedy slot and a sampled
    penalized slot share the pool with a greedy one; each equals its
    one-shot rollout."""
    eng, image_req, text_req = setup
    samp = dict(temperature=0.9, top_p=0.9, top_k=50)
    reqs = [(image_req([8, 9]), 10, dict(samp, seed=1)),
            (text_req([7, 8, 9, 10]), 12, dict(samp, seed=2)),
            (image_req([11]), 9, dict(repetition_penalty=1.3)),
            (text_req([20, 21, 22]), 8,
             dict(samp, seed=5, repetition_penalty=1.2)),
            (image_req([50, 51]), 7, {})]
    want = _oneshot(eng, reqs)
    results, stats = _serve(eng, reqs, n_slots=3, t_max=256, chunk=3)
    for i, (res, w) in enumerate(zip(results, want)):
        assert res.tokens == w, (i, res.tokens, w)
    assert stats["admitted"] == len(reqs)
    # the seeds matter: another seed gives another rollout
    other = eng.generate(**reqs[0][0], max_new_tokens=10,
                         eos_token_ids=(-1,), **dict(samp, seed=9)).tokens
    assert other != results[0].tokens


def test_int8_pool_kernel_path_matches_plain(setup):
    """An int8 pool: the default decode (the kernel's plain version on CPU
    tensors) and the dense plain path give the same tokens."""
    eng, image_req, text_req = setup
    reqs = [(image_req([8, 9]), 10, {}), (text_req([7, 8, 9, 10]), 8, {}),
            (image_req([12, 13]), 6, dict(temperature=0.8, seed=4))]
    a, _ = _serve(eng, reqs, n_slots=2, t_max=256, chunk=4, kv_quant="int8")
    b, _ = _serve(eng, reqs, n_slots=2, t_max=256, chunk=4, kv_int8=True,
                  decode_attn="plain")
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert all(len(r.tokens) == m for r, (_, m, _) in zip(a, reqs))


def test_too_long_served_oneshot_and_eos(setup):
    """A request that cannot fit the pool is served one-shot; an EOS stops
    its slot early (and is left out)."""
    eng, image_req, text_req = setup
    long_req = text_req(list(range(40, 140)))  # 128-bucket + 40 > t_max
    full = eng.generate(**text_req([7, 8, 9]), max_new_tokens=8,
                        eos_token_ids=(-1,)).tokens
    bat = ContinuousBatcher(eng, n_slots=2, t_max=140, chunk=4)
    try:
        got = bat.submit(long_req, 40, (-1,))
        cut = bat.submit(text_req([7, 8, 9]), 8, (full[3],))
    finally:
        bat.shutdown()
    assert got.tokens == eng.generate(**long_req, max_new_tokens=40,
                                      eos_token_ids=(-1,)).tokens
    assert bat.stats["rejected_too_long"] == 1
    assert cut.tokens == full[:full.index(full[3])]
    with pytest.raises(RuntimeError, match="shut down"):
        bat.submit(text_req([1, 2]), 2)
