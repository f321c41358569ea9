"""Evaluation harness: requests -> engine generation or scoring -> metrics.

The port's counterpart of ``visionselector_tpu.eval.evaluator``, in the
role of ``lmms-eval/lmms_eval/evaluator.py`` (simple_evaluate / evaluate):
per-task request building, rank sharding, generation and multiple-choice
scoring through an adapter over the port's ``QwenVLEngine``, metric
aggregation with bootstrap stderr, and the EVAL_TIME timing probes whose
printed lines ``extract_time`` scrapes (``qwen-evaluation/extract_time.py``).

The reference's ``VST_*`` environment switches are not read: the next
request's host inputs are always prepared on a worker thread (the
reference's default ``VST_EVAL_PREFETCH``), decoding is one request at a
time (batched and speculative decoding are not ported; ``api.run_eval``
refuses their flags), and the window layout is always the aligned one.
``EVAL_TIME=true`` is the reference harness's own contract and is kept.
A doc's images (one or several) or its video (``preprocess.video``) reach
the engine in one request.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from visionselector_tpu_torch.eval.tasks import (
    TASKS,
    Request,
    aggregate_scores,
    load_task_docs,
    shard_requests,
)


@dataclasses.dataclass
class EvalTimeStats:
    prefill_ms: List[float] = dataclasses.field(default_factory=list)
    latency_ms: List[float] = dataclasses.field(default_factory=list)
    visual_tokens: List[int] = dataclasses.field(default_factory=list)
    input_tokens: List[int] = dataclasses.field(default_factory=list)
    output_tokens: List[int] = dataclasses.field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        def avg(x):
            return float(np.mean(x)) if x else 0.0

        return {
            "avg_prefill_ms": avg(self.prefill_ms),
            "avg_latency_ms": avg(self.latency_ms),
            "avg_visual_tokens": avg(self.visual_tokens),
            "avg_input_tokens": avg(self.input_tokens),
            "avg_output_tokens": avg(self.output_tokens),
        }


class EngineAdapter:
    """generate_until-contract adapter (``lmms-eval/lmms_eval/api/model.py:58``)
    over the port's ``QwenVLEngine`` and a tokenizer (``encode(str) ->
    ids``, ``decode(ids, skip_special_tokens=True) -> str``).

    ``generate_until`` prepares the next group's host inputs (image
    decode, patchify, tokenize) on a worker thread while the engine runs
    the current one. ``decode_batch`` > 1 decodes up to that many requests
    of the same ``max_new_tokens`` together (``engine.generate_batch``).
    ``speculative`` = N > 0 decodes each request that runs alone with
    prompt-lookup speculative decoding (``model.generate_speculative``, N
    proposals per step; the same greedy tokens); batched groups still go
    through ``generate_batch``, as in the reference."""

    def __init__(self, engine, tokenizer, eval_time: bool = False,
                 visualize_dir: Optional[str] = None,
                 model_tag: str = "", min_pixels: Optional[int] = None,
                 max_pixels: Optional[int] = None, decode_batch: int = 1,
                 speculative: int = 0):
        from visionselector_tpu_torch.preprocess.image import (
            PROCESSOR_MAX_PIXELS,
            PROCESSOR_MIN_PIXELS,
        )

        self.engine = engine
        self.tokenizer = tokenizer
        # HF fast (Rust) tokenizers are not re-entrant: a prefetch-thread
        # encode racing a main-thread decode can raise RuntimeError('Already
        # borrowed'). Every tokenizer call here takes this lock (host work,
        # never held across device dispatch).
        self._tok_lock = threading.Lock()
        # per-image pixel budget (reference model_args min_pixels /
        # max_pixels, qwen2_5_vl_with_token_compression.py:70-78)
        self.min_pixels = (PROCESSOR_MIN_PIXELS if min_pixels is None
                           else int(min_pixels))
        self.max_pixels = (PROCESSOR_MAX_PIXELS if max_pixels is None
                           else int(max_pixels))
        # identifies the model in response-cache keys (family + checkpoint)
        self.model_tag = model_tag or type(engine).__name__
        self.eval_time = eval_time or (
            os.environ.get("EVAL_TIME", "").lower() == "true")
        # heatmap / mask PNGs per evaluated sample (the _visual adapter,
        # qwen2_5_vl_with_token_compression_visual.py:418-663)
        self.visualize_dir = visualize_dir
        self.stats = EvalTimeStats()
        self.decode_batch = max(1, int(decode_batch))
        self.speculative = int(speculative or 0)

    def _encode_prompt(self, question: str):
        """(before, after) ids of the Qwen chat template around the
        vision tokens; an engine's ``chat_template(question)`` overrides
        it."""
        from visionselector_tpu_torch.api.predict import chat_prompt_ids

        custom = getattr(self.engine, "chat_template", None)
        if custom is not None:
            return custom(question)
        with self._tok_lock:
            return chat_prompt_ids(self.tokenizer, question)

    def _bucket_key(self, req: Request) -> int:
        """The vision bucket the engine will pick for ``req`` (image sizes
        read without decoding; the aligned window layout of a windowed
        tower, the raw patch count of RICE), so requests run
        sorted by it (lmms-eval's sort-by-length Collator,
        ``utils.py:863-927``); 0 for text-only."""
        if req.image_path is None:
            return 0
        try:
            from PIL import Image

            from visionselector_tpu_torch.models.qwen25vl.model import (
                VISION_BUCKETS,
            )
            from visionselector_tpu_torch.preprocess.image import smart_resize
            from visionselector_tpu_torch.preprocess.indices import (
                aligned_window_len,
                pick_bucket,
            )

            vis = self.engine.cfg.vision
            factor = vis.patch_size * vis.spatial_merge_size
            grids = []
            for path in req.image_paths:
                with Image.open(path) as im:
                    w, h = im.size
                hb, wb = smart_resize(h, w, factor=factor,
                                      min_pixels=self.min_pixels,
                                      max_pixels=self.max_pixels)
                grids.append((1, hb // vis.patch_size, wb // vis.patch_size))
            if hasattr(vis, "window_size"):
                total = aligned_window_len(
                    np.asarray(grids), window_size=vis.window_size,
                    spatial_merge_size=vis.spatial_merge_size,
                    patch_size=vis.patch_size)
            else:  # RICE: no windows, the raw patch count
                total = sum(t * gh * gw for t, gh, gw in grids)
            return pick_bucket(total, list(getattr(
                self.engine, "vision_buckets", VISION_BUCKETS)))
        except (ImportError, OSError, ValueError):
            # no PIL, an unreadable image, or an aspect ratio smart_resize
            # refuses: the request sorts last and fails in its own turn
            return 1 << 30

    def _prepare_request(self, req: Request):
        """The engine ``generate`` kwargs for one request, and its grid
        (for the visualization hook; None for text-only and video)."""
        from visionselector_tpu_torch.preprocess.image import (
            preprocess_image,
        )
        from visionselector_tpu_torch.preprocess.rope import (
            expand_vision_tokens,
        )

        cfg = self.engine.cfg
        before, after = self._encode_prompt(req.question)
        if req.video_path is not None:
            from visionselector_tpu_torch.preprocess.video import (
                process_video,
            )

            pixels, grid, spg = process_video(
                req.video_path, patch_size=cfg.vision.patch_size,
                temporal_patch_size=cfg.vision.temporal_patch_size,
                merge_size=cfg.vision.spatial_merge_size)
            input_ids = expand_vision_tokens(
                before, after, grid,
                spatial_merge_size=cfg.vision.spatial_merge_size,
                image_token_id=cfg.video_token_id,
                vision_start_token_id=cfg.vision_start_token_id,
                vision_end_token_id=cfg.vision_end_token_id)
            return dict(input_ids=input_ids, pixel_values_videos=pixels,
                        video_grid_thw=grid,
                        second_per_grid_ts=np.array([spg])), None
        if req.image_path is None:
            # text-only request: the engine prefills the plain token
            # sequence, no vision branch
            input_ids = np.concatenate([before, after]).astype(np.int64)
            return dict(input_ids=input_ids), None
        from PIL import Image

        # One or several images (MMMU docs hold several), each preprocessed
        # on its own, pixel rows concatenated, one grid row per image (the
        # HF processor's batched call,
        # ``qwen25vl/processing_qwen2_5_vl.py:48-219``).
        pixel_list, grid_list = [], []
        for path in req.image_paths:
            px, g = preprocess_image(
                Image.open(path), min_pixels=self.min_pixels,
                max_pixels=self.max_pixels, patch_size=cfg.vision.patch_size,
                temporal_patch_size=cfg.vision.temporal_patch_size,
                merge_size=cfg.vision.spatial_merge_size)
            pixel_list.append(px)
            grid_list.append(g)
        pixels = np.concatenate(pixel_list, axis=0)
        grid = np.concatenate(grid_list, axis=0)
        input_ids = expand_vision_tokens(
            before, after, grid,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            image_token_id=cfg.image_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
            vision_end_token_id=cfg.vision_end_token_id)
        return dict(input_ids=input_ids, pixel_values=pixels,
                    grid_thw=grid), grid

    def _postprocess(self, req: Request, res, grid, until) -> str:
        """Decoded text cut at the first stop string; the visualization
        and the EVAL_TIME probes."""
        cfg = self.engine.cfg
        if (self.visualize_dir and req.video_path is None
                and len(req.image_paths) == 1
                and res.selected_indices is not None):
            from PIL import Image

            from visionselector_tpu_torch.eval.visualize import (
                visualize_selection,
            )

            os.makedirs(self.visualize_dir, exist_ok=True)
            img_arr = np.asarray(Image.open(req.image_path).convert("RGB"))
            visualize_selection(
                img_arr, res.scores, res.selected_indices, grid,
                os.path.join(self.visualize_dir,
                             f"{req.task.name}_{req.doc_id}"),
                spatial_merge_size=cfg.vision.spatial_merge_size)
        with self._tok_lock:
            text = self.tokenizer.decode(res.tokens, skip_special_tokens=True)
        for stop in until:
            if stop in text:
                text = text.split(stop)[0]

        if self.eval_time:
            kept = (len(res.selected_indices)
                    if res.selected_indices is not None
                    else res.num_vision_tokens)
            self.stats.prefill_ms.append(res.prefill_seconds * 1e3)
            self.stats.latency_ms.append(res.total_seconds * 1e3)
            self.stats.visual_tokens.append(kept)
            self.stats.input_tokens.append(res.prefill_len)
            self.stats.output_tokens.append(len(res.tokens))
            print(f"Input visual token number is: {kept}")
            print(f"Generation prefill time is: {res.prefill_seconds * 1e3}")
            print(f"Generation total time is: {res.total_seconds * 1e3}")
        return text.strip()

    def generate_until(self, requests: Sequence[Request],
                       until: Sequence[str] = ("<|im_end|>",)
                       ) -> List[str]:
        """Greedy answers in the requests' order, run sorted by vision
        bucket, each to its task's ``max_new_tokens``: in groups of up to
        the adapter's ``decode_batch`` consecutive requests of the same
        ``max_new_tokens``, one batched decode per group."""
        order = sorted(range(len(requests)),
                       key=lambda i: self._bucket_key(requests[i]))
        groups, i = [], 0
        while i < len(order):
            mnt = requests[order[i]].task.max_new_tokens
            group = [order[i]]
            while (len(group) < self.decode_batch and i + len(group) < len(order)
                   and requests[order[i + len(group)]].task.max_new_tokens
                   == mnt):
                group.append(order[i + len(group)])
            i += len(group)
            groups.append(group)
        out_by_pos = [None] * len(requests)
        ex = ThreadPoolExecutor(max_workers=1)

        def prep(group):
            return [self._prepare_request(requests[j]) for j in group]

        try:
            fut = ex.submit(prep, groups[0]) if groups else None
            for n, group in enumerate(groups):
                prepared = fut.result()
                fut = (ex.submit(prep, groups[n + 1])
                       if n + 1 < len(groups) else None)
                mnt = requests[group[0]].task.max_new_tokens
                if len(group) == 1 and self.speculative > 0:
                    from visionselector_tpu_torch.models.qwen25vl import (
                        model as qmodel,
                    )

                    results = [qmodel.generate_speculative(
                        self.engine, **prepared[0][0], max_new_tokens=mnt,
                        propose_len=self.speculative)]
                elif len(group) == 1:
                    results = [self.engine.generate(**prepared[0][0],
                                                    max_new_tokens=mnt)]
                else:
                    results = self.engine.generate_batch(
                        [kw for kw, _ in prepared], max_new_tokens=mnt)
                for j, (_, grid), res in zip(group, prepared, results):
                    out_by_pos[j] = self._postprocess(requests[j], res, grid,
                                                      until)
        finally:
            # stop the prep worker even when generate or _postprocess
            # raises: a pending future would keep its thread alive
            ex.shutdown(cancel_futures=True)
        return out_by_pos

    def loglikelihood(self, requests: Sequence[tuple]) -> List[tuple]:
        """Score (Request, continuation text) pairs: [(sum log P(continuation
        | context + image), is_greedy), ...], the lmms model ABC's
        ``loglikelihood`` (``lmms-eval/lmms_eval/api/model.py:30-57``). The
        context is the request's chat-templated prompt with its image."""
        out = []
        for req, continuation in requests:
            kw, _grid = self._prepare_request(req)
            with self._tok_lock:
                cont_ids = np.asarray(self.tokenizer.encode(continuation),
                                      np.int64)
            out.append(self.engine.loglikelihood(continuation_ids=cont_ids,
                                                 **kw))
        return out

    def predict_multiple_choice(self,
                                requests: Sequence[Request]) -> List[str]:
        """Answer multiple-choice requests by the argmax of the choices'
        loglikelihoods (A-D when the doc carries no choices). The
        prediction is the option letter, which the multiple_choice metric
        compares with the gold letter. The context prefills once per
        request; each choice is one chunked decode forward
        (``run_loglikelihood_choices``)."""
        from visionselector_tpu_torch.models.qwen25vl.model import (
            run_loglikelihood_choices,
        )

        preds = []
        for req in requests:
            choices = list(req.choices) or ["A", "B", "C", "D"]
            kw, _grid = self._prepare_request(req)
            with self._tok_lock:
                cont_list = [
                    np.asarray(self.tokenizer.encode(" " + c.strip()),
                               np.int64)
                    for c in choices]
            lls = run_loglikelihood_choices(
                self.engine, kw.pop("input_ids"), cont_list, **kw)
            best = max(range(len(choices)), key=lambda i: lls[i][0])
            preds.append(chr(ord("A") + best))
        return preds

    def generate_until_multi_round(
            self, requests: Sequence[Request],
            until: Sequence[str] = ("<|im_end|>",)) -> List[str]:
        """Multi-turn generation (lmms ABC ``generate_until_multi_round``,
        ``api/model.py:77-93``): a request whose ``question`` is a list of
        per-round questions is answered round by round, each answer folded
        into the next round's prompt. Returns each request's last
        answer."""
        out = []
        for req in requests:
            rounds = (req.question if isinstance(req.question, list)
                      else [req.question])
            context, answer = "", ""
            for q in rounds:
                merged = (context + q) if context else q
                one = dataclasses.replace(req, question=merged)
                answer = self.generate_until([one], until)[0]
                context += f"{q}\n{answer}\n"
            out.append(answer)
        return out


def evaluate(adapter, task_names: Sequence[str], data_dir: str,
             limit: Optional[float] = None, rank: int = 0,
             world_size: int = 1,
             log_samples_path: Optional[str] = None) -> Dict[str, float]:
    """Run tasks and return the aggregated metric dict (plus each task's
    ``wall_s``, and the EVAL_TIME averages when the adapter collects
    them). Loglikelihood-typed tasks go to
    ``adapter.predict_multiple_choice``, the others to
    ``adapter.generate_until``; with ``LM_HARNESS_CACHE_PATH`` set, cached
    responses are served and only the misses run."""
    from visionselector_tpu_torch.eval.caching import ResponseCache

    cache = ResponseCache()
    engine = adapter.engine
    method = (
        getattr(getattr(engine, "strategy", None), "name", None)
        or ("selector" if getattr(engine, "use_selector", False) else "orig"))
    budget = float(getattr(engine, "budget", 0.0))

    results: Dict[str, float] = {}
    samples_log = []
    for name in task_names:
        task = TASKS[name]
        requests = load_task_docs(task, data_dir, limit=limit)
        requests = shard_requests(requests, rank, world_size)
        t0 = time.perf_counter()
        # dispatch by the task's request type (lmms-eval:
        # ``resps = getattr(lm, reqtype)(cloned_reqs)``, evaluator.py:476)
        run = (adapter.predict_multiple_choice
               if task.request_type == "loglikelihood"
               else adapter.generate_until)
        if cache.enabled():
            keys = [
                cache.key(name, r.doc_id, r.question,
                          f"{adapter.model_tag}:{method}:"
                          f"{task.request_type}", budget)
                for r in requests]
            preds = [cache.get(k) for k in keys]
            miss = [i for i, p in enumerate(preds) if p is None]
            if miss:
                fresh = run([requests[i] for i in miss])
                for i, p in zip(miss, fresh):
                    preds[i] = p
                    cache.put(keys[i], p)
        else:
            preds = run(requests)
        results.update(aggregate_scores(task, preds, requests))
        results[f"{name}/wall_s"] = time.perf_counter() - t0
        if log_samples_path:
            for r, p in zip(requests, preds):
                samples_log.append(
                    {"task": name, "doc_id": r.doc_id, "question": r.question,
                     "answers": r.answers, "prediction": p,
                     "is_padding": r.is_padding})
    if adapter.eval_time:
        results.update(adapter.stats.summary())
    if log_samples_path:
        with open(log_samples_path, "w") as f:
            for s in samples_log:
                f.write(json.dumps(s) + "\n")
    return results


def merge_results(sample_log_paths: Sequence[str]) -> Dict[str, float]:
    """Combine per-rank sample logs into one aggregate, each doc counted
    once: records are deduplicated by (task, doc_id), padding rows and
    double runs alike, and rescored (lmms-eval gathers rank results and
    drops the padding requests, ``lmms-eval/lmms_eval/evaluator.py:
    442-476``)."""
    by_task: Dict[str, Dict[int, dict]] = {}
    for path in sample_log_paths:
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("is_padding"):
                    continue
                by_task.setdefault(rec["task"], {}).setdefault(
                    rec["doc_id"], rec)
    results: Dict[str, float] = {}
    for name, docs in by_task.items():
        task = TASKS[name]
        requests, preds = [], []
        for doc_id in sorted(docs):
            rec = docs[doc_id]
            requests.append(Request(
                doc_id=doc_id, question=rec["question"],
                answers=[str(a) for a in rec["answers"]], image_path=None,
                task=task))
            preds.append(rec["prediction"])
        results.update(aggregate_scores(task, preds, requests))
    return results
