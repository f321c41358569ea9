"""The port's ``OVEngine`` (``visionselector_tpu_torch.models.llava_ov15``)
against the JAX package's on llava_ov_tiny, with the same weights
(``ov_from_jax_params``) and inputs made with numpy from a seed:
selected indices bit-equal and 8 greedy tokens equal for the selector,
``orig``, text-only, two images, video frames, VisionZip and FastV (4
decoder layers), first-token logits within 1e-4 (fp32); sampling and
streaming; ``loglikelihood`` and the choices within 1e-4;
``generate_batch`` and ``ContinuousBatcher`` equal to one-shot
``generate``."""

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_ov_params import (  # noqa: F401 (one_thread: autouse fixture)
    EOS,
    configs,
    one_thread,
    ov_tree,
    port_params,
    requests,
)

from visionselector_tpu.models.llava_ov15 import model as jmodel
from visionselector_tpu.models.qwen25vl import model as jqmodel
from visionselector_tpu.selector import baselines as jbase
from visionselector_tpu_torch.models.llava_ov15 import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.continuous import (
    ContinuousBatcher,
)
from visionselector_tpu_torch.models.qwen25vl.model import (
    run_loglikelihood_choices,
)
from visionselector_tpu_torch.selector import baselines as tbase

ATOL = 1e-4
NEW_TOKENS = 8


@pytest.fixture(scope="module")
def weights():
    tree = ov_tree()
    return tree, jax.tree.map(jnp.asarray, tree), port_params(tree)


@pytest.fixture(scope="module")
def weights4():
    tree = ov_tree(layers=4)
    return tree, jax.tree.map(jnp.asarray, tree), port_params(tree, 4)


GENERATE_CASES = [
    ("selector", "image"), ("orig", "image"), ("selector", "text"),
    ("selector", "two images"), ("orig", "two images"),
    ("selector", "video"), ("visionzip", "image"), ("fastv", "image"),
]


def _port_engine(method, tp, layers=2):
    strategy = (None if method in ("selector", "orig")
                else tbase.get_baseline(method))
    return tmodel.OVEngine(configs(layers)[1], tp, strategy=strategy,
                           use_selector=method == "selector", budget=0.3,
                           device="cpu")


def _engines(method, jp, tp, layers=2):
    """(JAX engine, port engine) for ``method`` at budget 0.3."""
    strategy = (None if method in ("selector", "orig")
                else jbase.get_baseline(method))
    return (jmodel.OVEngine(configs(layers)[0], jp, strategy=strategy,
                            use_selector=method == "selector", budget=0.3),
            _port_engine(method, tp, layers))


def _jax_first_logits(jeng, req):
    """The reference engine's first-token logits (its GenerationResult
    does not carry them): its own prefill state."""
    state = jeng.generate(**req, max_new_tokens=2, eos_token_ids=EOS,
                          _defer_decode=True)
    return np.asarray(state.logits)


@pytest.mark.parametrize("method, req", GENERATE_CASES,
                         ids=[f"{m}-{r}" for m, r in GENERATE_CASES])
def test_generate_matches_jax_engine(weights, weights4, method, req):
    w = weights4 if method == "fastv" else weights
    _, jp, tp = w
    jeng, teng = _engines(method, jp, tp, 4 if method == "fastv" else 2)
    r = requests()[req]
    want = jeng.generate(**r, max_new_tokens=NEW_TOKENS, eos_token_ids=EOS)
    got = teng.generate(**r, max_new_tokens=NEW_TOKENS, eos_token_ids=EOS)
    assert got.num_vision_tokens == want.num_vision_tokens
    assert got.prefill_len == want.prefill_len
    if want.selected_indices is None:
        assert got.selected_indices is None
    else:
        np.testing.assert_array_equal(got.selected_indices,
                                      want.selected_indices)
    if method == "selector" and req != "text":
        s = np.sort(np.asarray(got.scores))[::-1]
        k = len(got.selected_indices)
        # the gap the bit-equality relies on, far above fp32 noise
        assert s[k - 1] - s[k] > 1e-4 * np.abs(s).max(), (s[k - 1], s[k])
    np.testing.assert_allclose(got.logits.numpy(),
                               _jax_first_logits(jeng, r), atol=ATOL, rtol=0)
    assert got.tokens == want.tokens
    assert len(set(got.tokens)) > 1  # the weights give varied tokens


def test_generate_sampling_knobs_and_stream(weights):
    """Sampled, top-k, repetition penalty: a streamed rollout equals the
    non-streamed one, and another seed changes it."""
    _, _, tp = weights
    teng = _port_engine("selector", tp)
    r = requests()["image"]
    kw = dict(max_new_tokens=12, eos_token_ids=EOS, temperature=0.8,
              top_p=0.9, top_k=40, repetition_penalty=1.2)
    chunks = []
    streamed = teng.generate(**r, seed=3, on_token_chunk=chunks.append, **kw)
    plain = teng.generate(**r, seed=3, **kw)
    assert streamed.tokens == plain.tokens == sum(chunks, [])
    assert chunks[0] == plain.tokens[:1]
    assert teng.generate(**r, seed=4, **kw).tokens != plain.tokens


@pytest.mark.parametrize("method, req", [("selector", "image"),
                                         ("orig", "two images"),
                                         ("orig", "text")])
def test_loglikelihood_matches_jax(weights, method, req):
    _, jp, tp = weights
    jeng, teng = _engines(method, jp, tp)
    r = dict(requests()[req])
    ids = r.pop("input_ids")
    cont = np.array([500, 612, 77, 9], np.int64)
    want = jeng.loglikelihood(ids, cont, **r)
    got = teng.loglikelihood(ids, cont, **r)
    assert abs(got[0] - want[0]) < ATOL and got[1] == want[1]


def test_choices_match_jax_and_loglikelihood(weights):
    """One prefill, one chunk per choice: equal to the reference's choices
    within 1e-4, and on ``orig`` to per-choice loglikelihood."""
    _, jp, tp = weights
    jeng, teng = _engines("orig", jp, tp)
    r = dict(requests()["image"])
    ids = r.pop("input_ids")
    choices = [np.array([5]), np.array([7, 8, 9]), np.array([11, 12])]
    want = jqmodel.run_loglikelihood_choices(jeng, ids, choices, **r)
    got = run_loglikelihood_choices(teng, ids, choices, **r)
    for (g, gg), (w, wg), c in zip(got, want, choices):
        assert abs(g - w) < ATOL and gg == wg
        assert abs(g - teng.loglikelihood(ids, c, **r)[0]) < ATOL


def test_generate_batch_matches_oneshot(weights):
    _, _, tp = weights
    teng = _port_engine("selector", tp)
    reqs = [requests()[k] for k in ("image", "text", "two images", "video")]
    got = teng.generate_batch(reqs, max_new_tokens=NEW_TOKENS,
                              eos_token_ids=EOS)
    for r, g in zip(reqs, got):
        want = teng.generate(**r, max_new_tokens=NEW_TOKENS,
                             eos_token_ids=EOS)
        assert g.tokens == want.tokens


def test_continuous_batcher_matches_oneshot(weights):
    """Six requests through four slots of a ``ContinuousBatcher`` over an
    ``OVEngine`` (one-shot admissions, also with ``prefill_chunk`` set:
    the engine has no segmented prefill), one of them sampled: each equals
    one-shot ``generate``."""
    _, _, tp = weights
    teng = _port_engine("selector", tp)
    rq = requests()
    samp = dict(temperature=0.9, top_p=0.9, top_k=50, seed=1)
    reqs = [(rq["image"], 9, {}), (rq["text"], 6, {}),
            (rq["two images"], 7, {}), (rq["video"], 5, {}),
            (rq["image"], 8, samp), (rq["text"], 4, {})]
    want = [teng.generate(**r, max_new_tokens=m, eos_token_ids=EOS,
                          **s).tokens for r, m, s in reqs]
    bat = ContinuousBatcher(teng, n_slots=4, t_max=512, chunk=4,
                            prefill_chunk=64)
    try:
        with cf.ThreadPoolExecutor(max_workers=len(reqs)) as ex:
            futs = [ex.submit(bat.submit, r, m, EOS, **s)
                    for r, m, s in reqs]
            got = [f.result(timeout=120).tokens for f in futs]
    finally:
        bat.shutdown()
    assert got == want
    assert bat.stats["admitted"] == len(reqs)
    assert bat.stats["chunked_admissions"] == 0
