"""Single-sample inference CLI for the PyTorch port.

Usage:
    python -m visionselector_tpu_torch.api.predict \\
        --method selector --budget 0.2 [--image photo.jpg] [--prompt-ids 1,2,3]

``--family qwen25vl`` (the default) or ``llava_ov15`` (LLaVA-OneVision-1.5:
the RICE tower, temporal patch 1, and the Qwen3 text model; ``OVEngine``).
Without --model-path it runs the family's tiny random-weight config (smoke
mode), as ``visionselector_tpu.api.predict`` does. ``--model-path`` loads
a Hugging Face checkpoint directory of the family (``config.json`` and one
or more ``*.safetensors``, a trained ``importance_scorer`` among them or not:
``api.train`` writes ``importance_scorer.safetensors``, which can be
copied into the directory); without a scorer ``--method selector`` runs
as ``orig``; any other ``--method`` is a training-free baseline
(``selector.baselines``: visionzip, prumerge_plus, divprune, holov, random,
fastv, dart, dynamic) at ``--budget``. The prompt is ``--prompt``, in the
Qwen chat template, when the directory holds a tokenizer that
``transformers`` can load
(``load_tokenizer``), else token ids (``--prompt-ids``; a host without
``transformers`` takes these). It runs on the GPU
(``--device cuda``, the default; the attention runs the CUDA kernels,
compiled on first use) and fails without one; ``--device cpu`` asks for
the CPU. ``--speculative N`` decodes with prompt-lookup speculative
decoding (``model.generate_speculative``, N proposals per verify step;
greedy tokens equal the plain decode's) and adds its dispatch and
acceptance counts to the printed line. ``--quantize int8 | int4 |
int4:g<N>`` quantizes the decoder's matmul kernels right after the weights
load (``lm.apply_weight_quantization``; decode rows then run the
weight-only GEMM kernel on the card) and adds the spec to the printed
line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

METHODS = ("orig", "selector", "visionzip", "prumerge_plus", "divprune",
           "holov", "fastv", "dart", "dynamic", "random",
           # the reference CLI's spellings
           "visionzip_official", "prumerge+")
# reference name -> registry name
METHOD_ALIASES = {"visionzip_official": "visionzip",
                  "prumerge+": "prumerge_plus"}


FAMILIES = ("qwen25vl", "llava_ov15")


def load_model(family: str, model_path, device: str, seed: int = 0,
               quantize=None):
    """(config, parameters) of ``family``: the HF directory at
    ``model_path`` on ``device`` (the config's dtype), or without one the
    family's tiny random-weight config from ``seed``, bf16 on the card (the
    kernels' dtype; the tiny configs are fp32) and fp32 on the CPU. A
    ``--quantize`` spec (``lm.apply_weight_quantization``) quantizes the
    decoder right after the weights load; a bad spec raises ValueError
    before anything loads."""
    import torch

    from visionselector_tpu_torch.models.qwen25vl.lm import (
        apply_weight_quantization,
        parse_quantize_spec,
    )

    parse_quantize_spec(quantize)
    cfg, params = _load_weights(family, model_path, device, seed)
    return cfg, apply_weight_quantization(params, quantize)


def _load_weights(family: str, model_path, device: str, seed: int):
    import torch

    if family == "llava_ov15":
        from visionselector_tpu_torch.core.config import llava_ov_tiny as tiny
        from visionselector_tpu_torch.models.llava_ov15.model import (
            init_ov_params as init,
        )
        from visionselector_tpu_torch.models.llava_ov15.weights import (
            load_ov_checkpoint as load,
            ov_config_from_hf as config_from,
        )
    else:
        from visionselector_tpu_torch.core.config import qwen25vl_tiny as tiny
        from visionselector_tpu_torch.models.qwen25vl.weights import (
            config_from_hf as config_from,
            init_params as init,
            load_hf_checkpoint as load,
        )
    if model_path:
        cfg = config_from(model_path)
        return cfg, load(model_path, cfg, device)
    cfg = tiny()
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, init(cfg, gen, device,
                     torch.bfloat16 if device == "cuda" else None)


def make_engine(family: str, cfg, params, method: str, budget: float,
                device: str):
    """The family's engine for ``--method``: the LIS selector, ``orig``,
    or a training-free baseline (``selector.baselines``)."""
    from visionselector_tpu_torch.selector.baselines import get_baseline

    if family == "llava_ov15":
        from visionselector_tpu_torch.models.llava_ov15.model import (
            OVEngine as Engine,
        )
    else:
        from visionselector_tpu_torch.models.qwen25vl.model import (
            QwenVLEngine as Engine,
        )
    strategy = (None if method in ("orig", "selector")
                else get_baseline(method))
    return Engine(cfg, params, use_selector=method == "selector",
                  budget=budget, strategy=strategy, device=device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-path", default=None, help="HF checkpoint dir")
    p.add_argument("--family", default="qwen25vl", choices=FAMILIES)
    p.add_argument("--image", default=None, help="image file path")
    p.add_argument("--prompt", default="Describe this image.",
                   help="the question, through the checkpoint's tokenizer "
                        "(needs --model-path and transformers)")
    p.add_argument("--prompt-ids", default=None,
                   help="comma-separated token ids after the image (skips "
                        "the tokenizer)")
    p.add_argument("--method", default="selector", choices=METHODS)
    p.add_argument("--budget", type=float, default=0.2)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantize", default=None,
                   help="weight-only LM quantization: int8 (per-channel), "
                        "int4, or int4:g<N> (grouped, e.g. int4:g128); "
                        "int4 packs 2 weights/byte of HBM")
    p.add_argument("--speculative", type=int, default=0,
                   help="prompt-lookup speculative decoding: propose N "
                        "tokens per verify step (greedy-identical outputs)")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="cuda (default) or cpu; cuda without a GPU fails")
    p.add_argument("--eval-time", action="store_true",
                   help="print timing probes (EVAL_TIME parity)")
    return p


def load_tokenizer(model_path):
    """The checkpoint directory's tokenizer through ``transformers``
    (imported here only), or None, with the reason on stderr, when
    ``transformers`` is missing or the directory holds no tokenizer."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(model_path, local_files_only=True)
    except (ImportError, OSError, ValueError) as e:
        print(f"[predict] tokenizer unavailable ({e}); use --prompt-ids",
              file=sys.stderr)
        return None


def chat_prompt_ids(tokenizer, prompt: str):
    """Qwen2.5-VL chat template around one image: returns (before, after)
    token ids."""
    before = tokenizer.encode(
        "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        "<|im_start|>user\n")
    after = tokenizer.encode(f"{prompt}<|im_end|>\n<|im_start|>assistant\n")
    return before, after


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.method = METHOD_ALIASES.get(args.method, args.method)
    if os.environ.get("EVAL_TIME", "").lower() == "true":
        args.eval_time = True
    import torch

    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    cfg, params = load_model(args.family, args.model_path, args.device,
                             args.seed, args.quantize)
    tokenizer = None
    if args.model_path and not args.prompt_ids:
        tokenizer = load_tokenizer(args.model_path)

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
    elif tokenizer is not None:
        before, after = chat_prompt_ids(tokenizer, args.prompt)
    else:
        before, after = [100, 200], [300, 400]  # smoke-mode placeholder
    input_ids = expand_vision_tokens(
        before, after, grid,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id,
    )

    engine = make_engine(args.family, cfg, params, args.method, args.budget,
                         args.device)
    if args.speculative > 0:
        from visionselector_tpu_torch.models.qwen25vl.model import (
            generate_speculative,
        )

        res = generate_speculative(engine, input_ids, pixels, grid,
                                   max_new_tokens=args.max_new_tokens,
                                   propose_len=args.speculative)
    else:
        res = engine.generate(input_ids, pixels, grid,
                              max_new_tokens=args.max_new_tokens)
    out = {
        "family": args.family,
        "method": args.method,
        "budget": args.budget,
        "device": args.device,
        "quantize": args.quantize,
        "tokens": res.tokens,
        "text": (tokenizer.decode(res.tokens, skip_special_tokens=True)
                 if tokenizer is not None else None),
        "selector": engine.use_selector,
        "num_vision_tokens": res.num_vision_tokens,
        "kept_vision_tokens": (
            len(res.selected_indices) if res.selected_indices is not None
            else res.num_vision_tokens),
        "prefill_len": res.prefill_len,
    }
    if args.speculative > 0:
        out.update(decode_dispatches=res.decode_dispatches,
                   spec_proposed=res.spec_proposed,
                   spec_accepted=res.spec_accepted)
    if args.eval_time:
        print(f"Input visual token number is: {out['kept_vision_tokens']}")
        print(f"Generation prefill time is: {res.prefill_seconds * 1e3}")
        print(f"Generation total time is: {res.total_seconds * 1e3}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
