"""The segmented tower and chunked admission of the port against the JAX
package's on qwen25vl_tiny (CPU, fp32; ``VST_ATTN_IMPL=xla`` from
conftest): ``vit_forward_segment`` in groups against the whole tower under
each attention configuration, ``start_chunked_prefill`` -> ``step`` ->
``finish`` against the fused prefill and the JAX ``ChunkedPrefill``
(cache rows within ATOL), the continuous batcher with ``prefill_chunk``
and with a ``prefix_store`` against one-shot ``generate``, its refusals,
and ``run_eval --decode-batch`` against the sequential run. The weights
and requests are ``torch_serving_params``'."""

import concurrent.futures as cf
import json
import time

import numpy as np
import pytest
import torch
from torch_serving_params import (  # noqa: F401 (one_thread: autouse)
    EOS,
    one_thread,
    request,
    run_chunked,
    serving_engines,
)

from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl import vit as tvit
from visionselector_tpu_torch.models.qwen25vl.continuous import (
    ContinuousBatcher,
)
from visionselector_tpu_torch.models.qwen25vl.weights import pad_vit_head_dim

ATOL = 1e-5
TIMEOUT = 120  # seconds per batcher submit


@pytest.fixture(scope="module")
def w():
    return serving_engines()


@pytest.mark.parametrize("variant", [None, "fused", "packed"])
def test_vit_segments_equal_whole_tower(w, variant):
    """The tower in block groups [0, 1), [1, 3), [3, depth) gives the
    whole tower's hidden states bit for bit, under each attention
    configuration (packed: heads padded in the weights)."""
    eng = w["tsel"]
    p = eng._prep_vision(w["ids_for"]([8]), w["px"], w["grid"], w["grid"],
                         None, None)
    vt = eng._vision_tensors(p.vb)
    visual = eng.params.visual
    if variant == "packed":
        visual = pad_vit_head_dim(visual, eng.cfg.vision)
    seg_variant = "fused" if variant == "fused" else None
    kw = {k: vt[k] for k in ("rot_pos_ids", "window_seg_ids",
                             "full_seg_ids", "window_kv_bounds",
                             "full_kv_bounds", "window_diag",
                             "window_kv_iters", "full_kv_iters")}
    depth = eng.cfg.vision.depth
    with torch.no_grad():
        whole = tvit.vit_forward(visual, vt["pixel_values"],
                                 reverse_index=vt["reverse_index"],
                                 attn_variant=seg_variant, **kw)
        x = tvit.vit_embed(visual, vt["pixel_values"])
        for lo, hi in ((0, 1), (1, 3), (3, depth)):
            x = tvit.vit_forward_segment(
                visual, x, lo=lo, hi=hi, attn_variant=seg_variant, **kw)
        merged = tvit.vit_merge(visual, x, vt["reverse_index"], visual.cfg)
    assert torch.equal(merged, whole)


def _vit_steps(w, vit_segments: int) -> int:
    """Steps before the decoder segments: the tower's block groups and the
    compaction (none when the tower runs in the start call)."""
    if vit_segments <= 1:
        return 0
    depth = w["tsel"].cfg.vision.depth
    return -(-depth // -(-depth // vit_segments)) + 1


@pytest.mark.parametrize("seg, vit_segments", [(8, 0), (8, 3), (512, 0)])
def test_chunked_prefill_state_matches_fused_and_jax(w, seg, vit_segments):
    """``start_chunked_prefill`` -> ``step``* -> ``finish`` gives the fused
    prefill's state (next token, start_pos, selected indices, cache rows
    below the valid length within ATOL) and the JAX ``ChunkedPrefill``'s;
    a segment longer than the sequence is one step."""
    ids, px, grid = w["ids_for"]([8, 9, 10, 11]), w["px"], w["grid"]
    kw = dict(max_new_tokens=6, eos_token_ids=EOS, prefill_chunk=seg,
              vit_segments=vit_segments)
    job = w["tsel"].start_chunked_prefill(ids, px, grid, **kw)
    got, steps = run_chunked(job)
    fused = w["tsel"].generate(ids, px, grid, max_new_tokens=6,
                               eos_token_ids=EOS, _defer_decode=True)
    jst, jsteps = run_chunked(
        w["jsel"].start_chunked_prefill(ids, px, grid, **kw))
    vl = fused.result.prefill_len
    assert steps == jsteps == -(-vl // seg) + _vit_steps(w, vit_segments)
    assert got.next_token == fused.next_token == jst.next_token
    assert got.start_pos == fused.start_pos == jst.start_pos
    assert got.rope_delta == fused.rope_delta == jst.rope_delta
    assert got.result.prefill_len == vl == jst.result.prefill_len
    np.testing.assert_array_equal(got.result.selected_indices,
                                  fused.result.selected_indices)
    np.testing.assert_array_equal(got.result.selected_indices,
                                  jst.result.selected_indices)
    assert got.cache.length.eq(vl).all()
    for name in ("k", "v"):
        rows = getattr(got.cache, name)[:, :, :vl].numpy()
        np.testing.assert_allclose(
            rows, getattr(fused.cache, name)[:, :, :vl].numpy(), atol=ATOL,
            rtol=0)
        np.testing.assert_allclose(
            rows, np.asarray(getattr(jst.cache, name))[:, :, :vl], atol=ATOL,
            rtol=0)
    # the state decodes one-shot like the fused one
    assert tmodel._run_decode_loop(
        w["tsel"].params, got.cache, got.next_token, got.start_pos, EOS,
        6) == w["tsel"].generate(ids, px, grid, max_new_tokens=6,
                                 eos_token_ids=EOS).tokens


def test_chunked_prefill_not_for_text_or_strategy(w):
    assert w["tsel"].start_chunked_prefill(np.arange(5, 9)) is None
    assert w["tfastv"].start_chunked_prefill(
        w["ids_for"]([8]), w["px"], w["grid"]) is None


def test_batcher_chunked_admission_matches_oneshot(w):
    """prefill_chunk=8 (and the tower in 2 groups): every result equals
    one-shot ``generate``; a slot live when an image request is admitted
    mid-decode is undisturbed; the stats count the steps."""
    eng = w["tsel"]
    long_text = (request(w, "text")[0], 40, {})
    imgs = [(dict(input_ids=w["ids_for"](q), pixel_values=w["px"],
                  grid_thw=w["grid"]), m, s)
            for q, m, s in (([8, 9], 12, {}), ([8, 40, 41], 6, {}),
                            ([50], 9, dict(temperature=0.7, top_k=20,
                                           seed=2)))]
    bat = ContinuousBatcher(eng, n_slots=2, t_max=256, chunk=2,
                            prefill_chunk=8, prefill_vit_segments=2)
    try:
        first = cf.ThreadPoolExecutor(max_workers=1).submit(
            bat.submit, long_text[0], long_text[1], EOS)
        deadline = time.monotonic() + TIMEOUT
        while not bat.live.any():  # wait until the text request decodes
            assert time.monotonic() < deadline and not first.done()
            time.sleep(0.001)
        with cf.ThreadPoolExecutor(max_workers=3) as ex:
            futs = [ex.submit(bat.submit, r, m, EOS, **s)
                    for r, m, s in imgs]
            results = [f.result(timeout=TIMEOUT) for f in futs]
        text_res = first.result(timeout=TIMEOUT)
    finally:
        bat.shutdown()
    for res, (r, m, s) in zip([text_res] + results, [long_text] + imgs):
        assert res.tokens == eng.generate(**r, max_new_tokens=m,
                                          eos_token_ids=EOS, **s).tokens
    st = bat.stats
    assert st["chunked_admissions"] == 3 and st["admitted"] == 4
    vl = [eng.generate(**r, max_new_tokens=1, eos_token_ids=EOS,
                       _defer_decode=True).result.prefill_len
          for r, _, _ in imgs]
    # per image: the tower's groups, the compaction, ceil(vl / 8) segments
    assert st["prefill_chunks"] == sum(_vit_steps(w, 2) + -(-n // 8)
                                       for n in vl)
    assert st["mid_flight_joins"] >= 1 and st["max_decode_gap_ms"] > 0


def test_batcher_prefix_store_counts_hits(w):
    """Admissions through a prefix store: repeats and shared prefixes hit,
    a penalized request bypasses it, and every result equals one-shot."""
    eng = w["tsel"]
    store = tmodel.PrefixCacheStore(min_prefix=1)
    reqs = [(dict(input_ids=w["ids_for"](q), pixel_values=w["px"],
                  grid_thw=w["grid"]), 6, s)
            for q, s in (([8, 9], {}), ([8, 9], {}), ([8, 60, 61], {}),
                         ([8, 62], dict(repetition_penalty=1.3)))]
    bat = ContinuousBatcher(eng, n_slots=2, t_max=256, chunk=3,
                            prefix_store=store, prefill_chunk=8)
    try:
        results = [bat.submit(r, m, EOS, **s) for r, m, s in reqs]
    finally:
        bat.shutdown()
    for res, (r, m, s) in zip(results, reqs):
        assert res.tokens == eng.generate(**r, max_new_tokens=m,
                                          eos_token_ids=EOS, **s).tokens
    assert (store.misses, store.hits) == (1, 2)
    assert bat.stats["chunked_admissions"] == 0  # the store wins


def test_batcher_refusals(w):
    """Auto windows stay refused; the int4 pool and speculative slots
    (ported since) construct, and a bad ``kv_quant`` raises."""
    for kw in ({"kv_quant": "int4"}, {"speculative": 2}):
        ContinuousBatcher(w["tsel"], n_slots=2, t_max=64, **kw).shutdown()
    with pytest.raises(ValueError, match="kv_quant"):
        ContinuousBatcher(w["tsel"], n_slots=2, t_max=64, kv_quant="int2")
    with pytest.raises(ValueError, match="live prefix"):
        ContinuousBatcher(w["tsel"], n_slots=2, t_max=64, auto_window=True)


# -- run_eval --decode-batch -------------------------------------------------------


def test_run_eval_decode_batch_equals_sequential(tmp_path, capsys):
    """``api.run_eval --decode-batch 2`` (image and text-only docs) prints
    the results of the sequential run (mirrors test_batch_decode.py's
    harness case)."""
    from PIL import Image

    from visionselector_tpu_torch.api import run_eval

    rng = np.random.RandomState(3)
    for name in ("a.png", "b.png"):
        Image.fromarray((rng.rand(56, 56, 3) * 255).astype(np.uint8)).save(
            tmp_path / name)
    with open(tmp_path / "mme.jsonl", "w") as f:
        for doc in ({"question": "Q1?", "answers": ["yes"],
                     "images": ["a.png"]},
                    {"question": "Q2?", "answers": ["yes"],
                     "images": ["b.png"]},
                    {"question": "Q3?", "answers": ["yes"]}):
            f.write(json.dumps(doc) + "\n")
    printed = []
    for batch in ("1", "2"):
        out = tmp_path / f"out{batch}"
        assert run_eval.main(["--data-dir", str(tmp_path), "--tasks", "mme",
                              "--device", "cpu", "--output-dir", str(out),
                              "--decode-batch", batch]) == 0
        with open(out / "samples_selector_0.2_rank0.jsonl") as f:
            printed.append([json.loads(line)["prediction"] for line in f])
    assert printed[0] == printed[1] and len(printed[0]) == 3
