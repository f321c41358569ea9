"""Single-sample inference CLI for the PyTorch port.

Usage:
    python -m visionselector_tpu_torch.api.predict \\
        --method selector --budget 0.2 [--image photo.jpg] [--prompt-ids 1,2,3]

Without --model-path it runs the tiny random-weight config (smoke mode),
as ``visionselector_tpu.api.predict`` does. ``--model-path`` loads a
Qwen2.5-VL Hugging Face checkpoint directory (``config.json`` and one or
more ``*.safetensors``, a trained ``importance_scorer`` among them or not:
``api.train`` writes ``importance_scorer.safetensors``, which can be
copied into the directory); without a scorer ``--method selector`` runs
as ``orig``. Prompts are token ids (``--prompt-ids``). It runs on the GPU
(``--device cuda``, the default; the attention runs the CUDA kernels,
compiled on first use) and fails without one; ``--device cpu`` asks for
the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

METHODS = ("orig", "selector")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-path", default=None, help="HF checkpoint dir")
    p.add_argument("--image", default=None, help="image file path")
    p.add_argument("--prompt-ids", default=None,
                   help="comma-separated token ids after the image")
    p.add_argument("--method", default="selector", choices=METHODS)
    p.add_argument("--budget", type=float, default=0.2)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="cuda (default) or cpu; cuda without a GPU fails")
    p.add_argument("--eval-time", action="store_true",
                   help="print timing probes (EVAL_TIME parity)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if os.environ.get("EVAL_TIME", "").lower() == "true":
        args.eval_time = True
    import torch

    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        config_from_hf,
        init_params,
        load_hf_checkpoint,
    )
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    if args.model_path:
        cfg = config_from_hf(args.model_path)
        params = load_hf_checkpoint(args.model_path, cfg, args.device)
    else:
        cfg = qwen25vl_tiny()
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        # bf16 on the card: the kernels' dtype (the tiny config is fp32)
        params = init_params(cfg, gen, args.device,
                             torch.bfloat16 if args.device == "cuda"
                             else None)

    tp = cfg.vision.temporal_patch_size
    if args.image:
        from PIL import Image

        pixels, grid = preprocess_image(Image.open(args.image),
                                        temporal_patch_size=tp)
    else:
        rng = np.random.RandomState(args.seed)
        img = (rng.rand(112, 112, 3) * 255).astype(np.uint8)
        pixels, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9,
                                        temporal_patch_size=tp)
    if args.prompt_ids:
        before, after = [], [int(x) for x in args.prompt_ids.split(",")]
    else:
        before, after = [100, 200], [300, 400]  # smoke-mode placeholder
    input_ids = expand_vision_tokens(
        before, after, grid,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id,
    )

    engine = QwenVLEngine(cfg, params, use_selector=args.method == "selector",
                          budget=args.budget, device=args.device)
    res = engine.generate(input_ids, pixels, grid,
                          max_new_tokens=args.max_new_tokens)
    out = {
        "method": args.method,
        "budget": args.budget,
        "device": args.device,
        "tokens": res.tokens,
        "selector": engine.use_selector,
        "num_vision_tokens": res.num_vision_tokens,
        "kept_vision_tokens": (
            len(res.selected_indices) if res.selected_indices is not None
            else res.num_vision_tokens),
        "prefill_len": res.prefill_len,
    }
    if args.eval_time:
        print(f"Input visual token number is: {out['kept_vision_tokens']}")
        print(f"Generation prefill time is: {res.prefill_seconds * 1e3}")
        print(f"Generation total time is: {res.total_seconds * 1e3}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
