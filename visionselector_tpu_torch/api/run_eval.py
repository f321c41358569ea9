"""Benchmark-suite eval entry point of the PyTorch port (the reference's
``run_selector.sh`` / ``run_token_compression.sh`` scripts).

Usage:
    python -m visionselector_tpu_torch.api.run_eval \\
        --model-path /ckpt --data-dir /data \\
        --tasks chartqa,textvqa_val --method selector --budgets 0.1,0.2,0.3 \\
        --limit 8 --output-dir results/

Runs each (task x budget) cell on the engine of ``--family``
(``qwen25vl``, the default, or ``llava_ov15``: ``OVEngine``) (``--method``
``selector``, ``orig`` or a training-free baseline of
``selector.baselines``: visionzip, prumerge_plus, divprune, holov, random,
fastv, dart, dynamic; ``api.run_token_compression`` sweeps several),
writes ``<output-dir>/<method>_<budget>_rank<r>
.json`` and the per-rank sample log beside it, and prints the EVAL_TIME
probes when ``EVAL_TIME=true`` (scraped by ``eval.extract_time``).
``--rank`` / ``--world-size`` shard the requests across processes;
``--merge`` then scores the ranks' sample logs as one run,
``--from-log`` rescores earlier sample logs without a model, and
``--http-endpoint URL`` evaluates an OpenAI-compatible chat-completions
server (``eval.http_adapter``; the port's ``api.serve`` is one) instead of
local weights.

``--model-path`` loads a Hugging Face checkpoint directory and its
tokenizer (``transformers``, imported only by ``api.predict.
load_tokenizer``); without a tokenizer, or without ``--model-path`` (the
tiny random-weight smoke config), prompts go through ``_IdTokenizer``,
which maps words to ids by their hash, so its ids differ between
processes unless ``PYTHONHASHSEED`` is fixed. It runs on the GPU
(``--device cuda``, the default) and fails without one; ``--device cpu``
asks for the CPU.

``--decode-batch N`` decodes up to N requests of a task together
(``QwenVLEngine.generate_batch``; each request's tokens are its own
``generate``'s). ``--speculative N`` decodes every request that runs alone
with prompt-lookup speculative decoding (N proposals per verify step, the
same greedy tokens; the adapter's ``speculative`` argument); groups of
``--decode-batch`` > 1 still decode through ``generate_batch``.

Not ported yet, raising NotImplementedError with its ROADMAP §1 item:
``--quantize`` (9).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

METHODS = ("orig", "selector", "visionzip", "prumerge_plus", "divprune",
           "holov", "random", "fastv", "dart", "dynamic")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-path", required=False, default=None)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--tasks", required=True, help="comma-separated task names")
    p.add_argument("--method", default="selector", choices=METHODS)
    p.add_argument("--family", default="qwen25vl",
                   choices=("qwen25vl", "llava_ov15"))
    p.add_argument("--budgets", default="0.2", help="comma-separated ratios")
    p.add_argument("--limit", type=float, default=None,
                   help=">= 1: doc count; fraction in (0,1): share of docs "
                        "(lmms-eval --limit semantics)")
    p.add_argument("--output-dir", default="eval_results")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world-size", type=int, default=1)
    p.add_argument("--min-pixels", type=int, default=None,
                   help="per-image pixel floor (smart_resize lower bound)")
    p.add_argument("--max-pixels", type=int, default=None,
                   help="per-image pixel budget (reference model_args "
                        "max_pixels)")
    p.add_argument("--merge", action="store_true",
                   help="merge per-rank sample logs in --output-dir (run "
                        "after all ranks finish): each doc scored once")
    p.add_argument("--task-config-dir", default=None,
                   help="directory of YAML/JSON TaskConfig files to register "
                        "(lmms-eval per-task yaml extensibility)")
    p.add_argument("--visualize-dir", default=None,
                   help="write per-sample heatmap/mask PNGs (run_visual.sh "
                        "parity)")
    p.add_argument("--decode-batch", type=int, default=None,
                   help="requests per batched decode (default 1)")
    p.add_argument("--quantize", default=None,
                   help="weight-only LM quantization (not ported)")
    p.add_argument("--from-log", default=None,
                   help="re-score from previous sample logs instead of "
                        "running a model: comma-separated jsonl files or "
                        "directories (newest log wins per doc; lmms-eval "
                        "from_log parity)")
    p.add_argument("--speculative", type=int, default=None,
                   help="prompt-lookup speculative decoding: propose N "
                        "tokens per decode dispatch (greedy-identical "
                        "outputs); applies to unbatched decode")
    p.add_argument("--http-endpoint", default=None,
                   help="evaluate an OpenAI-compatible chat-completions "
                        "server instead of local weights (lmms-eval "
                        "openai_compatible parity): server root URL, e.g. "
                        "http://host:8000; works against api.serve")
    p.add_argument("--http-model", default="default",
                   help="payload model field for --http-endpoint")
    p.add_argument("--http-concurrency", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="cuda (default) or cpu; cuda without a GPU fails")
    return p


def _refuse_unported(args) -> None:
    refused = [
        (args.quantize is not None, "--quantize", 9),
    ]
    for hit, what, item in refused:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP §1 item {item})")


class _IdTokenizer:
    """Smoke-mode tokenizer: each word becomes an id from its hash (at most
    8 ids per text), ids decode to their decimal text. ``hash`` of a str
    changes with ``PYTHONHASHSEED``, so its ids are stable only within a
    process or under a fixed seed."""

    def encode(self, s):
        return [abs(hash(w)) % 1000 + 600 for w in s.split()][:8]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def _merge(args) -> int:
    from visionselector_tpu_torch.eval.evaluator import merge_results

    for budget in [float(b) for b in args.budgets.split(",")]:
        logs = sorted(glob.glob(os.path.join(
            args.output_dir,
            f"samples_{args.method}_{budget}_rank*.jsonl")))
        if not logs:
            continue
        merged = merge_results(logs)
        out_path = os.path.join(args.output_dir,
                                f"merged_{args.method}_{budget}.json")
        with open(out_path, "w") as f:
            json.dump({"method": args.method, "budget": budget,
                       "results": merged, "ranks": len(logs)}, f, indent=2)
        print(json.dumps({"budget": budget, **merged}))
    return 0


def _from_log(args) -> int:
    from visionselector_tpu_torch.eval.evaluator import evaluate
    from visionselector_tpu_torch.eval.replay import ReplayAdapter

    adapter = ReplayAdapter(args.from_log)
    os.makedirs(args.output_dir, exist_ok=True)
    results = evaluate(adapter, args.tasks.split(","), args.data_dir,
                       limit=args.limit, rank=args.rank,
                       world_size=args.world_size)
    with open(os.path.join(args.output_dir, "from_log.json"), "w") as f:
        json.dump({"method": "from_log", "logs": args.from_log,
                   "results": results}, f, indent=2)
    print(json.dumps(results))
    return 0


def _http_endpoint(args) -> int:
    from visionselector_tpu_torch.eval.evaluator import evaluate
    from visionselector_tpu_torch.eval.http_adapter import (
        OpenAICompatAdapter,
    )

    adapter = OpenAICompatAdapter(args.http_endpoint, model=args.http_model,
                                  concurrency=args.http_concurrency)
    os.makedirs(args.output_dir, exist_ok=True)
    results = evaluate(adapter, args.tasks.split(","), args.data_dir,
                       limit=args.limit, rank=args.rank,
                       world_size=args.world_size)
    with open(os.path.join(args.output_dir, "http_endpoint.json"), "w") as f:
        json.dump({"method": "http_endpoint",
                   "endpoint": args.http_endpoint, "results": results}, f,
                  indent=2)
    print(json.dumps(results))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

    if args.task_config_dir:
        from visionselector_tpu_torch.eval.tasks import load_task_configs

        registered = load_task_configs(args.task_config_dir)
        print(f"[run_eval] registered tasks: {registered}")
    if args.merge:
        return _merge(args)
    if args.from_log:
        return _from_log(args)
    if args.http_endpoint:
        return _http_endpoint(args)

    import torch

    from visionselector_tpu_torch.api.predict import (
        load_model,
        load_tokenizer,
        make_engine,
    )
    from visionselector_tpu_torch.eval.evaluator import EngineAdapter, evaluate
    from visionselector_tpu_torch.eval.tracker import EvaluationTracker

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    cfg, params = load_model(args.family, args.model_path, args.device)
    tokenizer = load_tokenizer(args.model_path) if args.model_path else None
    if tokenizer is None:
        tokenizer = _IdTokenizer()

    os.makedirs(args.output_dir, exist_ok=True)
    tasks = args.tasks.split(",")
    for budget in [float(b) for b in args.budgets.split(",")]:
        engine = make_engine(args.family, cfg, params, args.method, budget,
                             args.device)
        adapter = EngineAdapter(
            engine, tokenizer, visualize_dir=args.visualize_dir,
            model_tag=f"{args.family}:{args.model_path or 'smoke'}",
            min_pixels=args.min_pixels, max_pixels=args.max_pixels,
            decode_batch=args.decode_batch or 1,
            speculative=args.speculative or 0)
        results = evaluate(
            adapter, tasks, args.data_dir, limit=args.limit, rank=args.rank,
            world_size=args.world_size,
            log_samples_path=os.path.join(
                args.output_dir,
                f"samples_{args.method}_{budget}_rank{args.rank}.jsonl"))
        out_path = os.path.join(args.output_dir,
                                f"{args.method}_{budget}_rank{args.rank}.json")
        with open(out_path, "w") as f:
            json.dump({"method": args.method, "budget": budget,
                       "device": args.device, "results": results}, f,
                      indent=2)
        # EvaluationTracker persistence (timestamped results + metadata)
        tracker = EvaluationTracker(
            output_dir=os.path.join(args.output_dir, "tracker"),
            model_name=args.family,
            model_args=f"method={args.method},budget={budget},"
                       f"model_path={args.model_path}")
        tracker.save_results_aggregated(
            results, config={"tasks": tasks, "limit": args.limit,
                             "rank": args.rank,
                             "world_size": args.world_size})
        tracker.finish()
        print(json.dumps({"budget": budget, **results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
