"""One-command real-checkpoint acceptance for the PyTorch port: the first
thing to run where weights exist (counterpart of
``visionselector_tpu.api.acceptance``). It chains the readiness checks
against a checkpoint of either family:

1. **transcript**: record and at once re-verify a greedy transcript
   (``api.verify_checkpoint``): generation on this checkpoint is
   deterministic end to end (tokens, vision-token counts).
2. **golden_indices**: the engine's selected indices equal
   ``sort(argsort(-scores)[:k])`` of its own reported scores (the
   reference's top-k contract).
3. **regression8**: optional (``--data-dir`` + ``--tasks``): an 8-sample
   ``api.run_eval`` per task in process, recording the scores for
   cross-revision comparison (``eval.regression`` reads the same output).

Usage:
    python -m visionselector_tpu_torch.api.acceptance --model-path /ckpt \\
        [--family qwen25vl] [--budget 0.2] [--image chart.png] \\
        [--prompt-ids 1,2,3] [--data-dir EVAL_DATA --tasks chartqa] \\
        [--device cuda]

Exit 0 = every step passed; the last line is ``{"acceptance": "PASS" |
"FAIL", ...}``. Without ``--model-path`` it runs the family's tiny random
config (a smoke of the script itself). ``--prompt-ids`` is passed to
``api.predict`` (a host without ``transformers``, or a directory without
a tokenizer); ``--device cuda`` (the default) runs on the GPU and fails
without one, ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-path", default=None)
    p.add_argument("--family", default="qwen25vl",
                   choices=("qwen25vl", "llava_ov15"))
    p.add_argument("--budget", type=float, default=0.2)
    p.add_argument("--image", default=None)
    p.add_argument("--prompt", default="Describe this image.")
    p.add_argument("--prompt-ids", default=None,
                   help="comma-separated token ids after the image, passed "
                        "to api.predict (skips the tokenizer)")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--data-dir", default=None,
                   help="eval jsonl dir (eval.export_tasks output) for the "
                        "8-sample regression step")
    p.add_argument("--tasks", default=None,
                   help="comma list for the regression step")
    p.add_argument("--limit", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="cuda (default) or cpu; cuda without a GPU fails")
    return p


def step_transcript(args) -> dict:
    from visionselector_tpu_torch.api import verify_checkpoint

    base = ["--family", args.family, "--budget", str(args.budget),
            "--prompt", args.prompt,
            "--max-new-tokens", str(args.max_new_tokens),
            "--device", args.device]
    if args.prompt_ids:
        base += ["--prompt-ids", args.prompt_ids]
    if args.model_path:
        base += ["--model-path", args.model_path]
    if args.image:
        base += ["--image", args.image]
    with tempfile.TemporaryDirectory(prefix="vst_accept_") as tmp:
        rec = os.path.join(tmp, "transcript.json")
        rc = verify_checkpoint.main(base + ["--record", rec])
        if rc != 0:
            return {"ok": False, "error": f"record failed rc={rc}"}
        rc = verify_checkpoint.main(base + ["--verify", rec])
        with open(rec) as f:
            tokens = json.load(f)["tokens"]
    return {"ok": rc == 0, "tokens": len(tokens)}


def step_golden_indices(args) -> dict:
    import numpy as np

    from visionselector_tpu_torch.api.predict import load_model, make_engine
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    cfg, params = load_model(args.family, args.model_path, args.device)
    engine = make_engine(args.family, cfg, params, "selector", args.budget,
                         args.device)
    if args.image:
        from PIL import Image

        img = Image.open(args.image)
    else:
        img = (np.random.RandomState(0).rand(112, 112, 3) * 255
               ).astype(np.uint8)
    pixels, grid = preprocess_image(
        img, min_pixels=1, max_pixels=10**9,
        temporal_patch_size=cfg.vision.temporal_patch_size)
    ids = expand_vision_tokens(
        [100, 200], [300, 400], grid,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id)
    res = engine.generate(ids, pixels, grid, max_new_tokens=2)
    if res.selected_indices is None:
        return {"ok": False, "error": "the checkpoint has no scorer: "
                                      "nothing was selected"}
    scores = np.asarray(res.scores)
    n = res.num_vision_tokens
    k = len(res.selected_indices)
    want = np.sort(np.argsort(-scores[:n], kind="stable")[:k])
    got = np.sort(np.asarray(res.selected_indices))
    ok = bool(np.array_equal(want, got))
    out = {"ok": ok, "kept": int(k), "vision_tokens": int(n)}
    if not ok:
        out["mismatches"] = int((want != got).sum())
    return out


def step_regression(args) -> dict:
    # In process (not a subprocess): the acceptance run and its eval share
    # one process, its device and its built kernels.
    from visionselector_tpu_torch.api.run_eval import main as run_eval_main

    results = {}
    ok = True
    for task in args.tasks.split(","):
        with tempfile.TemporaryDirectory(
                prefix=f"vst_accept_{task}_") as out_dir:
            argv = ["--data-dir", args.data_dir, "--tasks", task,
                    "--method", "selector", "--budgets", str(args.budget),
                    "--limit", str(args.limit), "--output-dir", out_dir,
                    "--family", args.family, "--device", args.device]
            if args.model_path:
                argv += ["--model-path", args.model_path]
            try:
                rc = run_eval_main(argv)
            except Exception as e:  # noqa: BLE001 (a failed task is reported)
                ok = False
                results[task] = {"error": repr(e)}
                continue
            if rc != 0:
                ok = False
                results[task] = {"error": f"run_eval rc={rc}"}
                continue
            with open(os.path.join(
                    out_dir, f"selector_{args.budget}_rank0.json")) as f:
                results[task] = json.load(f)["results"]
    return {"ok": ok, "scores": results}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    steps = [("transcript", step_transcript),
             ("golden_indices", step_golden_indices)]
    if args.data_dir and args.tasks:
        steps.append(("regression8", step_regression))
    failed = False
    for name, fn in steps:
        try:
            res = fn(args)
        except Exception as e:  # noqa: BLE001 (report, keep going)
            res = {"ok": False, "error": repr(e)}
        failed = failed or not res.get("ok")
        print(json.dumps({"step": name, **res}), flush=True)
    print(json.dumps({"acceptance": "PASS" if not failed else "FAIL",
                      "model_path": args.model_path}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
