"""Warm-up for production serving (counterpart of
``visionselector_tpu.api.warmup``).

On the card a cold process pays one-time costs on its first requests:
the nvcc build of the CUDA kernels (``kernels/_build.py``; the library
is kept under ``kernels/build/``, keyed by a hash of the sources, so
this cost outlives the process), then in-process costs that do not: the
cuBLAS handle and workspace, the caching allocator's first blocks at
each size, and the lazy loading of the CUDA modules the first call of
each kernel and GEMM shape needs. This CLI builds the kernels, then
drives one synthetic generation per requested vision bucket, the
text-only request and ``generate_batch`` at 2, 4, ... up to
``--micro-batch``, printing one JSON line for each (its seconds are what
a cold process pays). Run it once per checkout before starting servers
(the build), or call ``main`` inside a serving process to warm that
process too.

Usage:
    python -m visionselector_tpu_torch.api.warmup \\
        [--model-path /ckpt] [--method selector] [--budget 0.2] \\
        [--buckets 512,1024,2048] [--max-new-tokens 8] [--micro-batch 4] \\
        [--device cuda|cpu]

Without ``--model-path`` it warms the tiny random-weight config. It runs
on the GPU (``--device cuda``, the default) and fails without one;
``--device cpu`` asks for the CPU (no kernels to build).
"""

from __future__ import annotations

import argparse
import json
import time


def synth_image_for_bucket(patches: int, patch_size: int = 14,
                           merge: int = 2):
    """An image whose patch count lands in (not above) the given bucket."""
    import numpy as np

    side_patches = int(np.sqrt(patches))
    side_patches -= side_patches % merge
    side_patches = max(side_patches, merge)
    px = side_patches * patch_size
    rng = np.random.RandomState(patches)
    return (rng.rand(px, px, 3) * 255).astype(np.uint8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-path", default=None)
    p.add_argument("--method", default="selector")
    p.add_argument("--budget", type=float, default=0.2)
    p.add_argument("--buckets", default="512,1024",
                   help="vision buckets (patch counts) to warm")
    p.add_argument("--max-new-tokens", type=int, default=4)
    p.add_argument("--micro-batch", type=int, default=1,
                   help="also warm generate_batch at 2, 4, ... up to this "
                        "size, for serve --micro-batch")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="cuda (default) or cpu; cuda without a GPU fails")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from visionselector_tpu_torch.api.predict import load_model, make_engine
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available "
                             "(pass --device cpu to run on the CPU)")
        from visionselector_tpu_torch.kernels import _build

        t0 = time.perf_counter()
        _build.load()
        print(json.dumps({"kernels_build_s": round(_build.BUILD_SECONDS, 2),
                          "load_s": round(time.perf_counter() - t0, 2)}),
              flush=True)

    cfg, params = load_model("qwen25vl", args.model_path, args.device)
    engine = make_engine("qwen25vl", cfg, params, args.method, args.budget,
                         args.device)
    vc = cfg.vision
    for bucket in [int(b) for b in args.buckets.split(",")]:
        img = synth_image_for_bucket(bucket, vc.patch_size,
                                     vc.spatial_merge_size)
        pixels, grid = preprocess_image(
            img, min_pixels=1, max_pixels=10**9, patch_size=vc.patch_size,
            temporal_patch_size=vc.temporal_patch_size,
            merge_size=vc.spatial_merge_size)
        ids = expand_vision_tokens(
            [100, 200], [300, 400], grid,
            image_token_id=cfg.image_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
            vision_end_token_id=cfg.vision_end_token_id)
        t0 = time.perf_counter()
        engine.generate(ids, pixels, grid,
                        max_new_tokens=args.max_new_tokens)
        print(json.dumps({
            "bucket": bucket, "patches": int(pixels.shape[0]),
            "warmup_s": round(time.perf_counter() - t0, 2)}), flush=True)
    t0 = time.perf_counter()
    engine.generate(np.asarray([100, 200, 300], np.int64),
                    max_new_tokens=args.max_new_tokens)
    print(json.dumps({"bucket": "text_only",
                      "warmup_s": round(time.perf_counter() - t0, 2)}),
          flush=True)
    # generate_batch at each size serve --micro-batch can hand it, the last
    # bucket's request in every row
    if args.micro_batch > 1:
        req = dict(input_ids=ids, pixel_values=pixels, grid_thw=grid)
        b = 2
        while b <= args.micro_batch:
            t0 = time.perf_counter()
            engine.generate_batch([req] * b,
                                  max_new_tokens=args.max_new_tokens)
            print(json.dumps({"decode_batch": b, "warmup_s": round(
                time.perf_counter() - t0, 2)}), flush=True)
            b *= 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
