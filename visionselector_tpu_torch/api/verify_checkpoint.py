"""Real-checkpoint smoke fixture for the PyTorch port: record / verify
greedy transcripts (counterpart of
``visionselector_tpu.api.verify_checkpoint``).

Greedy decoding and deterministic preprocessing make the token sequence a
bit-stable fingerprint of (weights x pipeline); the vision-token counts
pin the selector:

    # once, on a trusted setup (records greedy tokens + vision counts)
    python -m visionselector_tpu_torch.api.verify_checkpoint \\
        --model-path /ckpt --image chart.png --record transcript.json

    # afterwards / elsewhere (re-runs and diffs; exit 1 on a mismatch)
    python -m visionselector_tpu_torch.api.verify_checkpoint \\
        --model-path /ckpt --image chart.png --verify transcript.json

Each run is one ``api.predict`` call in process. ``--prompt-ids`` passes
token ids to it (a host without ``transformers``, or a checkpoint
directory without a tokenizer); ``--device cuda`` (the default) runs on
the GPU and fails without one, ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-path", default=None,
                   help="HF checkpoint dir; omitted = tiny smoke config")
    p.add_argument("--image", default=None,
                   help="image path; omitted = deterministic synthetic image")
    p.add_argument("--prompt", default="Describe this image.")
    p.add_argument("--prompt-ids", default=None,
                   help="comma-separated token ids after the image, passed "
                        "to api.predict (skips the tokenizer)")
    p.add_argument("--method", default="selector")
    p.add_argument("--family", default="qwen25vl",
                   choices=("qwen25vl", "llava_ov15"))
    p.add_argument("--budget", type=float, default=0.2)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="cuda (default) or cpu; cuda without a GPU fails")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--record", metavar="PATH",
                   help="write the transcript json")
    g.add_argument("--verify", metavar="PATH",
                   help="diff against a recorded transcript")
    return p


def _run(args) -> dict:
    """One greedy generation through ``api.predict``; returns the
    transcript payload."""
    import io
    from contextlib import redirect_stdout

    from visionselector_tpu_torch.api import predict

    argv = ["--method", args.method, "--family", args.family,
            "--budget", str(args.budget),
            "--max-new-tokens", str(args.max_new_tokens),
            "--prompt", args.prompt, "--device", args.device]
    if args.prompt_ids:
        argv += ["--prompt-ids", args.prompt_ids]
    if args.model_path:
        argv += ["--model-path", args.model_path]
    if args.image:
        argv += ["--image", args.image]
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = predict.main(argv)
    if rc != 0:
        raise RuntimeError(f"api.predict exited {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])

    img_sha = None
    if args.image:
        with open(args.image, "rb") as f:
            img_sha = hashlib.sha256(f.read()).hexdigest()
    return {
        "model_path": args.model_path,
        "family": args.family,
        "method": args.method,
        "budget": args.budget,
        "prompt": args.prompt,
        "prompt_ids": args.prompt_ids,
        "image_sha256": img_sha,
        "tokens": out["tokens"],
        "text": out.get("text"),
        "num_vision_tokens": out["num_vision_tokens"],
        "kept_vision_tokens": out["kept_vision_tokens"],
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    got = _run(args)

    if args.record:
        with open(args.record, "w") as f:
            json.dump(got, f, indent=2)
        print(f"[verify_checkpoint] recorded {len(got['tokens'])} tokens "
              f"-> {args.record}")
        return 0

    with open(args.verify) as f:
        want = json.load(f)
    problems = []
    for key in ("prompt", "prompt_ids", "method", "budget", "image_sha256"):
        if want.get(key) != got.get(key):
            problems.append(
                f"setup mismatch {key}: recorded={want.get(key)!r} "
                f"now={got.get(key)!r}")
    for key in ("tokens", "num_vision_tokens", "kept_vision_tokens"):
        if want.get(key) != got.get(key):
            problems.append(
                f"OUTPUT mismatch {key}: recorded={want.get(key)!r} "
                f"now={got.get(key)!r}")
    if problems:
        for msg in problems:
            print(f"[verify_checkpoint] {msg}", file=sys.stderr)
        return 1
    print(f"[verify_checkpoint] OK: {len(got['tokens'])} greedy tokens match")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
