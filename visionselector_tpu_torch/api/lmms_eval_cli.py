"""lmms-eval-style CLI front end of the PyTorch port (the reference's
invocation, ``lmms-eval/lmms_eval/__main__.py:84-271``: ``python -m
lmms_eval --model <name> --model_args key=val,... --tasks a,b --limit N``),
a thin wrapper over ``api.run_eval``:

    python -m visionselector_tpu_torch.api.lmms_eval_cli \\
        --model qwen2_5_vl_with_token_compression \\
        --model_args pretrained=/ckpt,method=selector,budgets=0.2 \\
        --tasks chartqa,textvqa_val --batch_size 1 \\
        --limit 8 --output_path results/ --log_samples --data_dir /data

``--batch_size`` > 1 maps to ``run_eval --decode-batch`` (decode
micro-batching); ``openai_compatible`` (model_args ``base_url=``,
``model=``) to ``run_eval --http-endpoint``. The LLaVA-OV-1.5 adapters map
to ``run_eval --family llava_ov15``.
"""

from __future__ import annotations

import argparse

# reference adapter names -> model families
MODEL_FAMILIES = {
    "qwen2_5_vl_with_token_compression": "qwen25vl",
    "qwen2_5_vl_with_token_compression_visual": "qwen25vl",
    "qwen2_5_vl": "qwen25vl",
    "llava_onevision1_5_with_token_compression": "llava_ov15",
    "llava_onevision1_5": "llava_ov15",
    # replay model: scores from previous sample logs, no checkpoint
    # (lmms-eval/lmms_eval/models/from_log.py)
    "from_log": None,
    # API model: any OpenAI-compatible chat-completions server
    # (lmms-eval/lmms_eval/models/openai_compatible.py)
    "openai_compatible": None,
}


def parse_model_args(s: str) -> dict:
    """Comma-separated key=value string (``simple_evaluate`` model_args).
    An item without ``=`` continues the previous key's value, so
    ``budgets=0.1,0.2,0.3`` keeps its commas."""
    out = {}
    last = None
    for item in (s or "").split(","):
        if not item.strip():
            continue
        if "=" not in item and last is not None:
            out[last] += "," + item.strip()
            continue
        k, _, v = item.partition("=")
        out[k.strip()] = v.strip()
        last = k.strip()
    return out


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--model_args", default="")
    p.add_argument("--tasks", required=True)
    p.add_argument("--batch_size", default="1",
                   help="prefill stays batch 1 (reference parity); an "
                        "integer > 1 asks for decode micro-batching "
                        "(run_eval --decode-batch)")
    p.add_argument("--limit", type=float, default=None)
    p.add_argument("--output_path", default="eval_results")
    p.add_argument("--log_samples", action="store_true")
    p.add_argument("--log_samples_suffix", default="")
    p.add_argument("--data_dir", default=None,
                   help="local jsonl dataset dir")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    return p


def run_eval_argv(args) -> list:
    """The ``api.run_eval`` arguments for a parsed lmms-eval command."""
    if args.model not in MODEL_FAMILIES:
        raise SystemExit(
            f"unknown --model {args.model!r}; have {sorted(MODEL_FAMILIES)}")
    ma = parse_model_args(args.model_args)
    data_dir = args.data_dir or ma.get("data_dir")
    limit = [] if args.limit is None else ["--limit", str(args.limit)]
    if args.model == "from_log":
        logs = ma.get("logs")
        if not logs or not data_dir:
            raise SystemExit("from_log needs model_args logs=<paths> and "
                             "--data_dir (reference: from_log.py:19)")
        return ["--from-log", logs, "--data-dir", data_dir, "--tasks",
                args.tasks, "--output-dir", args.output_path] + limit
    if args.model == "openai_compatible":
        base_url = ma.get("base_url")
        if not base_url or not data_dir:
            raise SystemExit(
                "openai_compatible needs model_args base_url=<url> and "
                "--data_dir (reference: openai_compatible.py)")
        return ["--http-endpoint", base_url, "--data-dir", data_dir,
                "--tasks", args.tasks, "--output-dir", args.output_path,
                "--http-model", ma.get("model", "default")] + limit
    if data_dir is None:
        raise SystemExit("--data_dir (or model_args data_dir=) is required: "
                         "datasets are local jsonl files")
    argv = ["--data-dir", data_dir, "--tasks", args.tasks,
            "--method", ma.get("method", "orig"),
            "--family", MODEL_FAMILIES[args.model],
            "--budgets", ma.get("budgets", ma.get("budget", "0.2")),
            "--output-dir", args.output_path, "--device", args.device]
    model_path = ma.get("pretrained", ma.get("model_path"))
    if model_path:
        argv += ["--model-path", model_path]
    for k in ("min_pixels", "max_pixels"):
        if k in ma:
            argv += [f"--{k.replace('_', '-')}", str(ma[k])]
    if args.batch_size.isdigit() and int(args.batch_size) > 1:
        argv += ["--decode-batch", args.batch_size]
    return argv + limit


def main(argv=None) -> int:
    from visionselector_tpu_torch.api.run_eval import main as run_eval_main

    return run_eval_main(run_eval_argv(build_parser().parse_args(argv)))


if __name__ == "__main__":
    raise SystemExit(main())
