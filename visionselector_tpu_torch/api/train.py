"""Selector training CLI for the PyTorch port (the reference's
``train_qwen_selector.py`` + ``scripts/sft_3b.sh``, and the OV trainer;
counterpart of ``visionselector_tpu.api.train --method selector``).

Usage:
    python -m visionselector_tpu_torch.api.train \\
        --model-path /ckpt --annotation data.jsonl --image-root imgs/ \\
        --output-dir runs/selector --budget 0.2 \\
        --reg-weight-start 0.1 --reg-weight-end 2.0 \\
        --lr 5e-5 --total-steps 1000 --batch-size 8

    python -m visionselector_tpu_torch.api.train --family llava_ov15 \\
        --model-path /ov-ckpt --annotation data.jsonl --image-root imgs/ \\
        --output-dir runs/ov --budget 0.2 \\
        --reg-weight-start 0.1 --reg-weight-end 3.0

    python -m visionselector_tpu_torch.api.train --smoke --total-steps 3 \\
        --output-dir runs/smoke [--family llava_ov15]

Only the LIS scorer trains (frozen backbone); AdamW with optax's
warmup-cosine schedule and global-norm clipping; linear reg-weight
curriculum; ``checkpoint-<step>`` auto-resume; ``train_log.jsonl``; the
final scorer exported to the reference's safetensors layout
(``importance_scorer.safetensors``, under the vision prefix of the
``--model-path`` checkpoint, else the family's: ``visual.`` for
Qwen2.5-VL, ``model.visual.`` for LLaVA-OneVision-1.5), which
``api.predict --model-path`` serves once copied into an HF directory of
that layout. ``--family llava_ov15`` trains the OV scorer (RICE tower,
Qwen3 decoder, 1-D rope; ``train.ov_loss``). ``--smoke`` (or no
``--model-path``) trains the family's tiny random-weight config on
synthetic data. It runs on the GPU (``--device cuda``, the default) and
fails without one; ``--device cpu`` asks for the CPU. ``transformers`` is
imported only for ``--annotation`` (the tokenizer).
"""

from __future__ import annotations

import argparse
import json
import os
import time

# What the port does not run yet, and the ROADMAP item that ports it.
UNPORTED_METHODS = {
    "sft": "full-model SFT (ROADMAP section 1, item 10)",
    "dpo": "DPO (ROADMAP section 1, item 10)",
    "grpo": "GRPO (ROADMAP section 1, item 10)",
    "dynamic": "the dynamic VisionPredictor (ROADMAP section 1, item 10)",
}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-path", default=None, help="HF checkpoint dir")
    p.add_argument("--annotation", default=None)
    p.add_argument("--image-root", default="")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--budget", type=float, default=0.2)
    p.add_argument("--reg-weight-start", type=float, default=0.1)
    p.add_argument("--reg-weight-end", type=float, default=2.0)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--max-grad-norm", type=float, default=1.0,
                   help="global-norm gradient clipping (0 disables)")
    p.add_argument("--gradient-checkpointing", action="store_true",
                   help="recompute each decoder layer's activations in the "
                        "backward (exact; less activation memory)")
    p.add_argument("--total-steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--grad-accum-steps", type=int, default=1,
                   help="micro-batches per optimizer update (effective "
                        "batch = batch-size * this)")
    p.add_argument("--vision-bucket", type=int, default=4096)
    p.add_argument("--text-bucket", type=int, default=2048)
    p.add_argument("--save-steps", type=int, default=200)
    p.add_argument("--async-save", action="store_true",
                   help="not ported (ROADMAP section 1, item 10)")
    p.add_argument("--log-steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--smoke", action="store_true",
                   help="tiny random model + synthetic data")
    p.add_argument("--family", default="qwen25vl",
                   choices=("qwen25vl", "llava_ov15"))
    p.add_argument("--method", default="selector",
                   choices=("selector", "dynamic", "sft", "dpo", "grpo"))
    p.add_argument("--lora-rank", type=int, default=0,
                   help="> 0 is not ported (ROADMAP section 1, item 10)")
    p.add_argument("--data-flatten", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="sequence packing; not ported (ROADMAP section 1, "
                        "item 10)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches built ahead in a background thread "
                        "(0 = synchronous)")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="cuda (default) or cpu; cuda without a GPU fails")
    return p


def _refuse_unported(args) -> None:
    if args.method != "selector":
        raise NotImplementedError(
            f"--method {args.method}: {UNPORTED_METHODS[args.method]} is "
            f"not ported yet")
    if args.data_flatten:
        raise NotImplementedError(
            "--data-flatten (packed rows) is not ported yet (ROADMAP "
            "section 1, item 10)")
    if args.lora_rank > 0:
        raise NotImplementedError(
            "--lora-rank > 0 is not ported yet (ROADMAP section 1, item 10)")
    if args.async_save:
        raise NotImplementedError(
            "--async-save is not ported yet (ROADMAP section 1, item 10)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    import numpy as np
    import torch

    from visionselector_tpu_torch.core.checkpoint import (
        maybe_resume,
        save_train_state,
    )
    from visionselector_tpu_torch.api.predict import load_model
    from visionselector_tpu_torch.core.params import init_random_
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        export_scorer_to_safetensors,
    )
    from visionselector_tpu_torch.selector.scorer import Scorer
    from visionselector_tpu_torch.train.data import stack_samples
    from visionselector_tpu_torch.train.loss import to_device
    from visionselector_tpu_torch.train.train_step import (
        ScheduleConfig,
        init_train_state,
        train_step_accum,
    )

    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    is_ov = args.family == "llava_ov15"
    cfg, params = load_model(args.family,
                             None if args.smoke else args.model_path, dev,
                             args.seed)
    scorer_prefix = _scorer_prefix(
        is_ov, None if args.smoke else args.model_path)
    if args.smoke or not args.model_path:
        args.vision_bucket = min(args.vision_bucket, 128)
        args.text_bucket = min(args.text_bucket, 128)
    elif params.scorer is None:
        sel = cfg.with_selector(args.budget).selector
        params.scorer = Scorer(sel, dev)
        init_random_(params.scorer, torch.Generator(device=dev).manual_seed(
            args.seed), std=sel.init_scale)

    def sample_stream():
        rng = np.random.RandomState(args.seed)
        if args.annotation:
            from transformers import AutoTokenizer

            from visionselector_tpu_torch.train.dataset import (
                ConversationDataset,
                build_sample_from_record,
            )
            from visionselector_tpu_torch.train.ov_loss import (
                build_ov_sample_from_record,
            )

            builder = (build_ov_sample_from_record if is_ov
                       else build_sample_from_record)
            tokenizer = AutoTokenizer.from_pretrained(
                args.model_path, local_files_only=True)
            ds = ConversationDataset(args.annotation, args.image_root,
                                     tokenizer)
            i = 0
            while True:
                rec = ds[i % len(ds)]
                i += 1
                yield builder(cfg, rec, args.budget, args.vision_bucket,
                              args.text_bucket)
        elif is_ov:  # synthetic smoke data (OV family)
            from visionselector_tpu_torch.train.ov_loss import (
                build_ov_train_sample,
            )

            while True:
                img = (rng.rand(56, 56, 3) * 255).astype(np.uint8)
                yield build_ov_train_sample(
                    cfg, img, [101, 102], [201, 202, 203],
                    answer_ids=[301, 302], budget=args.budget,
                    s_bucket=args.vision_bucket,
                    t_bucket=args.text_bucket)
        else:  # synthetic smoke data
            from visionselector_tpu_torch.train.data import (
                build_train_sample,
            )

            while True:
                img = (rng.rand(56, 56, 3) * 255).astype(np.uint8)
                yield build_train_sample(
                    cfg, img, [101, 102], [103], [201, 202, 203],
                    budget=args.budget, s_bucket=args.vision_bucket,
                    t_bucket=args.text_bucket, min_pixels=1,
                    max_pixels=10**9)

    sched = ScheduleConfig(
        total_steps=args.total_steps, lr=args.lr,
        weight_decay=args.weight_decay, warmup_ratio=args.warmup_ratio,
        max_grad_norm=args.max_grad_norm,
        remat=args.gradient_checkpointing,
        reg_weight_start=args.reg_weight_start,
        reg_weight_end=args.reg_weight_end)
    state = init_train_state(params, sched)
    state, resumed = maybe_resume(args.output_dir, state)
    if resumed:
        print(f"[train] resumed at step {state.step}")

    l_pad = args.vision_bucket // cfg.vision.spatial_merge_unit
    k_max = max(1, int(l_pad * args.budget))
    accum = max(1, args.grad_accum_steps)
    stream = sample_stream()

    def next_batch():
        """``accum`` micro-batches of ``batch-size`` samples, on the
        device."""
        return [to_device(stack_samples(
            [next(stream) for _ in range(args.batch_size)]), dev)
            for _ in range(accum)]

    prefetcher = None
    if args.prefetch > 0:
        from visionselector_tpu_torch.train.prefetch import BatchPrefetcher

        prefetcher = batch_iter = BatchPrefetcher(next_batch,
                                                  size=args.prefetch)
    else:
        batch_iter = iter(next_batch, None)

    os.makedirs(args.output_dir, exist_ok=True)
    log_path = os.path.join(args.output_dir, "train_log.jsonl")
    t0 = time.time()
    try:
        while state.step < args.total_steps:
            micro = next(batch_iter)
            state, metrics = train_step_accum(state, params, micro, cfg,
                                              k_max, sched)
            step = state.step
            if step % args.log_steps == 0 or step == args.total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, wall_s=round(time.time() - t0, 1))
                print(json.dumps(m))
                with open(log_path, "a") as f:
                    f.write(json.dumps(m) + "\n")
            if step % args.save_steps == 0 or step == args.total_steps:
                path = save_train_state(state, args.output_dir, step=step)
                print(f"[train] saved {path}")
    finally:
        # stop the prefetch thread even when a step raises
        if prefetcher is not None:
            prefetcher.close()

    export_scorer_to_safetensors(
        state.scorer,
        os.path.join(args.output_dir, "importance_scorer.safetensors"),
        prefix=scorer_prefix)
    print(f"[train] exported scorer to {args.output_dir}")
    _copy_loader_configs(args.model_path, args.output_dir)
    return 0


def _scorer_prefix(is_ov: bool, model_path) -> str:
    """The exported scorer's key prefix: ``<vision prefix>
    importance_scorer.`` of the base checkpoint (what its loader probes
    once the file is copied in), else the family's own layout."""
    from visionselector_tpu_torch.core.safetensors import open_checkpoint
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        resolve_qwen_prefixes,
    )

    if model_path:
        vis = resolve_qwen_prefixes(open_checkpoint(model_path).names)[0]
    else:
        vis = "model.visual." if is_ov else "visual."
    return f"{vis}importance_scorer."


def _copy_loader_configs(model_path, output_dir) -> None:
    """Copy the processor / tokenizer / model config files of the base
    checkpoint into the output dir, so the trained dir loads for eval (as
    the reference does after training)."""
    import shutil

    if not model_path or not os.path.isdir(model_path):
        return
    for name in ("preprocessor_config.json", "chat_template.json",
                 "tokenizer_config.json", "tokenizer.json", "vocab.json",
                 "merges.txt", "special_tokens_map.json", "config.json",
                 "generation_config.json"):
        src = os.path.join(model_path, name)
        dst = os.path.join(output_dir, name)
        if os.path.exists(src) and not os.path.exists(dst):
            shutil.copy2(src, dst)


if __name__ == "__main__":
    raise SystemExit(main())
