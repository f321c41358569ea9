"""Assemble an LLaVA-OneVision-1.5 checkpoint from a vision-tower checkpoint
and a language-model checkpoint (the reference's
``visionselector_tpu.api.merge_model``), checking each transplanted module
by the cosine similarity of its activations on a fixed probe against the
source checkpoint's.

Usage:
    python -m visionselector_tpu_torch.api.merge_model \\
        --vision-path /ckpt_with_visual --lm-path /ckpt_with_lm \\
        --output-dir merged/ [--smoke] [--device cpu]

Both inputs are HF safetensors checkpoint directories in the OV layout (the
RICE tower and a trained scorer are read from the first, the text model
from the second). The merged model is written as an HF directory,
``<output-dir>/merged/`` (``config.json`` + ``model.safetensors``; the
reference writes an orbax checkpoint), and the check runs on the files
read back, so it verifies the saved artifact; ``merge_report.json`` holds
the similarities (1.0 = bit-faithful transplant). ``--smoke`` merges two
random llava_ov_tiny models. It runs on the GPU (``--device cuda``, the
default) and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def cosine(a, b) -> float:
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def assemble(vision, lm, scorer=None, cfg=None):
    """``OVParams`` from a RICE tower, a text model and an optional
    scorer (shared, not copied)."""
    from visionselector_tpu_torch.models.llava_ov15.model import OVParams

    return OVParams(vision, lm, scorer, cfg)


def sanity_check(params, cfg, source_visual, source_lm) -> dict:
    """Cosine similarity of each transplanted module's activations on a
    fixed probe (a seeded 56x56 image through the tower, 8 seeded ids
    through the text model) against the source module's:
    {"visual": ..., "lm": ...}."""
    import torch

    from visionselector_tpu_torch.models.llava_ov15 import rice as rice_mod
    from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod
    from visionselector_tpu_torch.preprocess.image import preprocess_image

    dev = params.lm.embed_tokens.device
    rng = np.random.RandomState(0)
    img = (rng.rand(56, 56, 3) * 255).astype(np.uint8)
    pixels, grid = preprocess_image(
        img, min_pixels=1, max_pixels=10**9,
        patch_size=cfg.vision.patch_size,
        temporal_patch_size=cfg.vision.temporal_patch_size,
        merge_size=cfg.vision.spatial_merge_size)
    rb = rice_mod.build_rice_batch(
        pixels, grid, spatial_merge_size=cfg.vision.spatial_merge_size,
        pad_to=pixels.shape[0], cls_slots=4)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    def vis_fwd(tower):
        return rice_mod.rice_forward(
            tower, t(rb.pixel_values), t(rb.rot_pos_ids), t(rb.insert_map),
            t(rb.strip_map), t(rb.seg_ids)).float().cpu()

    n = 8
    ids = t(rng.randint(0, 1000, n))

    def lm_fwd(lm):
        embeds = lm_mod.embed_tokens(lm, ids)[None]
        pos = torch.arange(n, device=dev).expand(3, 1, n)
        seg = torch.ones((1, n), dtype=torch.int32, device=dev)
        return lm_mod.lm_prefill(lm, embeds, pos, seg)[0].float().cpu()

    with torch.no_grad():
        return {"visual": cosine(vis_fwd(params.visual),
                                 vis_fwd(source_visual)),
                "lm": cosine(lm_fwd(params.lm), lm_fwd(source_lm))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--vision-path", default=None)
    p.add_argument("--lm-path", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="random tiny parts (wiring check)")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="cuda (default) or cpu; cuda without a GPU fails")
    args = p.parse_args(argv)

    import torch

    from visionselector_tpu_torch.models.llava_ov15.weights import (
        load_ov_checkpoint,
        ov_config_from_hf,
        save_ov_checkpoint,
    )

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    dev = args.device
    if args.smoke or not (args.vision_path and args.lm_path):
        from visionselector_tpu_torch.core.config import llava_ov_tiny
        from visionselector_tpu_torch.models.llava_ov15.model import (
            init_ov_params,
        )

        cfg = llava_ov_tiny()
        a, b = (init_ov_params(cfg, torch.Generator(device=dev).manual_seed(s),
                               dev) for s in (1, 2))
    else:
        cfg = ov_config_from_hf(args.vision_path)
        a = load_ov_checkpoint(args.vision_path, cfg, dev)
        b = load_ov_checkpoint(args.lm_path, cfg, dev)
    params = assemble(a.visual, b.lm, a.scorer, cfg)

    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(args.output_dir), "merged")
    save_ov_checkpoint(params, cfg, path)
    restored = load_ov_checkpoint(path, ov_config_from_hf(path), dev,
                                  dtype=params.lm.embed_tokens.dtype)
    report = sanity_check(restored, cfg, a.visual, b.lm)
    ok = all(v > 0.999 for v in report.values())
    with open(os.path.join(args.output_dir, "merge_report.json"), "w") as f:
        json.dump({"cosine": report, "ok": ok}, f, indent=2)
    print(json.dumps({"cosine": report, "ok": ok, "saved": path}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
