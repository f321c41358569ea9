"""Training CLI for the PyTorch port (the reference's
``train_qwen_selector.py`` + ``scripts/sft_3b.sh``, ``train_qwen_dynamic.py``,
``train_qwen.py`` and the OV trainers; counterpart of
``visionselector_tpu.api.train``).

Usage:
    python -m visionselector_tpu_torch.api.train \\
        --model-path /ckpt --annotation data.jsonl --image-root imgs/ \\
        --output-dir runs/selector --budget 0.2 \\
        --reg-weight-start 0.1 --reg-weight-end 2.0 \\
        --lr 5e-5 --total-steps 1000 --batch-size 8 [--data-flatten]

    python -m visionselector_tpu_torch.api.train --family llava_ov15 \\
        --model-path /ov-ckpt --annotation data.jsonl --image-root imgs/ \\
        --output-dir runs/ov --budget 0.2 \\
        --reg-weight-start 0.1 --reg-weight-end 3.0

    python -m visionselector_tpu_torch.api.train --smoke --total-steps 3 \\
        --output-dir runs/smoke [--family llava_ov15] \\
        [--method dynamic | --method sft [--lora-rank 8]] [--async-save]

Methods (``--method``):
- ``selector`` (default): only the LIS scorer trains (frozen backbone),
  with the linear reg-weight curriculum; the final scorer is exported to
  the reference's safetensors layout (``importance_scorer.safetensors``,
  under the vision prefix of the ``--model-path`` checkpoint, else the
  family's: ``visual.`` for Qwen2.5-VL, ``model.visual.`` for
  LLaVA-OneVision-1.5), which ``api.predict --model-path`` serves once
  copied into an HF directory of that layout.
- ``dynamic`` (Qwen2.5-VL only): the Dynamic-Qwen predictor
  (``train.dynamic_train``: Gumbel straight-through keep mask at decoder
  layer 2, ``--tau-start`` / ``--tau-end``, ``--mask-loss-weight``),
  exported to ``image_score_predictor.safetensors``.
- ``sft``: plain CE training under the ``--tune-mm-vision`` /
  ``--tune-mm-mlp`` / ``--[no-]tune-mm-llm`` freeze policy, or of LoRA
  adapters (``--lora-rank`` > 0, ``--lora-alpha``), merged at the end into
  ``lora_merged/params.pt``.
- ``dpo`` and ``grpo`` are not ported yet (NotImplementedError).

Every method: AdamW with optax's warmup-cosine schedule and global-norm
clipping; ``checkpoint-<step>`` auto-resume (``--async-save`` writes them
on a background thread); ``train_log.jsonl``. ``--data-flatten`` packs
consecutive one-image ``--annotation`` records of the Qwen family into
shared rows (the reference's default 3B recipe). ``--family llava_ov15``
trains the OV model (RICE tower, Qwen3 decoder, 1-D rope;
``train.ov_loss``). ``--smoke`` (or no ``--model-path``) trains the
family's tiny random-weight config, on synthetic data unless
``--annotation`` is given. It runs on the GPU (``--device cuda``, the
default) and fails without one; ``--device cpu`` asks for the CPU.
``transformers`` is imported only for ``--annotation`` (the tokenizer).
"""

from __future__ import annotations

import argparse
import json
import os
import time

# What the port does not run yet, and the ROADMAP item that ports it.
UNPORTED_METHODS = {
    "dpo": "DPO (ROADMAP section 1, item 10)",
    "grpo": "GRPO (ROADMAP section 1, item 10)",
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
                   help="write checkpoints on a background thread while "
                        "training continues (at most one in flight; joined "
                        "before the exports and at exit)")
    p.add_argument("--log-steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--smoke", action="store_true",
                   help="tiny random model + synthetic data")
    p.add_argument("--family", default="qwen25vl",
                   choices=("qwen25vl", "llava_ov15"))
    p.add_argument("--method", default="selector",
                   choices=("selector", "dynamic", "sft", "dpo", "grpo"))
    p.add_argument("--tau-start", type=float, default=1.0,
                   help="--method dynamic: Gumbel temperature at step 0")
    p.add_argument("--tau-end", type=float, default=0.1,
                   help="--method dynamic: temperature at the last step")
    p.add_argument("--mask-loss-weight", type=float, default=100.0,
                   help="--method dynamic: weight of the keep-ratio MSE")
    # SFT freeze policy (the reference's tune_mm_* knobs); --tune-mm-llm is
    # on by default (an all-frozen SFT trains nothing).
    p.add_argument("--tune-mm-vision", action="store_true",
                   help="--method sft: train the vision tower")
    p.add_argument("--tune-mm-mlp", action="store_true",
                   help="--method sft: train the patch merger")
    p.add_argument("--tune-mm-llm", action=argparse.BooleanOptionalAction,
                   default=True, help="--method sft: train the decoder")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="--method sft: > 0 trains LoRA adapters of this "
                        "rank on the decoder's kernels instead")
    p.add_argument("--lora-alpha", type=int, default=16)
    p.add_argument("--data-flatten", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="pack consecutive one-image --annotation records "
                        "into shared rows (Qwen2.5-VL family)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches built ahead in a background thread "
                        "(0 = synchronous)")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="cuda (default) or cpu; cuda without a GPU fails")
    return p


def _refuse_unported(args) -> None:
    """NotImplementedError for what is not ported, ValueError for a
    combination the reference ignores without a word."""
    if args.method in UNPORTED_METHODS:
        raise NotImplementedError(
            f"--method {args.method}: {UNPORTED_METHODS[args.method]} is "
            f"not ported yet")
    is_ov = args.family == "llava_ov15"
    if args.data_flatten and is_ov:
        raise ValueError("--data-flatten packs Qwen2.5-VL rows only (the "
                         "reference ignores it for --family llava_ov15)")
    if args.data_flatten and not args.annotation:
        raise ValueError("--data-flatten packs --annotation records")
    if args.method == "dynamic" and is_ov:
        raise ValueError("--method dynamic trains the Qwen2.5-VL family's "
                         "predictor only")
    if args.lora_rank > 0 and args.method != "sft":
        raise ValueError("--lora-rank trains adapters under --method sft")


def _tokenizer(model_path):
    """The base checkpoint's HF tokenizer (``transformers`` is imported
    only here)."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_path, local_files_only=True)


def _packed_stream(cfg, ds, args, single_builder):
    """First-fit packing of at most 16 consecutive one-image records into
    one row (``dataset.build_packed_train_sample``), bounded by the text
    bucket and by the vision bucket on the window-aligned layout the port
    trains on (the reference bounds the raw patch count of its classic
    layout); videos, text-only and multi-image records go through
    ``single_builder`` unpacked (JAX ``api/train.py:129-190``)."""
    from visionselector_tpu_torch.preprocess.image import smart_resize
    from visionselector_tpu_torch.train.dataset import (
        build_packed_train_sample,
    )

    vc = cfg.vision
    factor = vc.patch_size * vc.spatial_merge_size
    win = vc.window_size // factor  # merged tokens along a window's side

    def est_cost(rec):
        """(vision-expanded ids, vision rows) without patchifying."""
        img = rec["image"]
        h, w = img.shape[:2] if hasattr(img, "shape") else img.size[::-1]
        hb, wb = smart_resize(h, w, factor=factor, min_pixels=56 * 56,
                              max_pixels=28 * 28 * 1280)
        mh, mw = hb // factor, wb // factor
        rows = -(-mh // win) * -(-mw // win) * win * win \
            * vc.spatial_merge_unit
        return len(rec["ids"]) + mh * mw + 2, rows

    def packable(rec):
        return (rec.get("video") is None and rec["image"] is not None
                and len(rec.get("images") or [rec["image"]]) == 1)

    def records():
        j = 0
        while True:
            yield ds[j % len(ds)]
            j += 1

    rit, pending = records(), None
    while True:
        group, tlen, rows = [], 0, 0
        while len(group) < 16:
            rec = pending if pending is not None else next(rit)
            pending = None
            if not packable(rec):
                pending = rec
                break
            et, er = est_cost(rec)
            if group and (tlen + et > args.text_bucket
                          or rows + er > args.vision_bucket):
                pending = rec
                break
            group.append(rec)
            tlen += et
            rows += er
        if group:
            yield build_packed_train_sample(
                cfg, group, args.budget, args.vision_bucket,
                args.text_bucket)
        if pending is not None and not packable(pending):
            yield single_builder(cfg, pending, args.budget,
                                 args.vision_bucket, args.text_bucket)
            pending = None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    import numpy as np
    import torch

    from visionselector_tpu_torch.api.predict import load_model
    from visionselector_tpu_torch.core.checkpoint import (
        AsyncSaver,
        maybe_resume,
        save_train_state,
    )
    from visionselector_tpu_torch.core.params import init_random_
    from visionselector_tpu_torch.selector.scorer import Scorer
    from visionselector_tpu_torch.train.data import stack_samples
    from visionselector_tpu_torch.train.loss import to_device

    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    is_ov = args.family == "llava_ov15"
    tiny = args.smoke or not args.model_path
    cfg, params = load_model(args.family, None if args.smoke
                             else args.model_path, dev, args.seed)
    scorer_prefix = _scorer_prefix(
        is_ov, None if args.smoke else args.model_path)
    if tiny and not args.annotation:  # synthetic samples: one 56x56 image
        args.vision_bucket = min(args.vision_bucket, 128)
        args.text_bucket = min(args.text_bucket, 128)
    if not tiny and params.scorer is None:
        sel = cfg.with_selector(args.budget).selector
        params.scorer = Scorer(sel, dev)
        init_random_(params.scorer, torch.Generator(device=dev).manual_seed(
            args.seed), std=sel.init_scale)

    def sample_stream():
        rng = np.random.RandomState(args.seed)
        if args.annotation:
            from visionselector_tpu_torch.train.dataset import (
                ConversationDataset,
                build_sample_from_record,
            )
            from visionselector_tpu_torch.train.ov_loss import (
                build_ov_sample_from_record,
            )

            builder = (build_ov_sample_from_record if is_ov
                       else build_sample_from_record)
            ds = ConversationDataset(args.annotation, args.image_root,
                                     _tokenizer(args.model_path))
            if args.data_flatten:  # the Qwen family (_refuse_unported)
                yield from _packed_stream(cfg, ds, args, builder)
                return
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

    l_pad = args.vision_bucket // cfg.vision.spatial_merge_unit
    k_max = max(1, int(l_pad * args.budget))
    common = dict(total_steps=args.total_steps, lr=args.lr,
                  weight_decay=args.weight_decay,
                  warmup_ratio=args.warmup_ratio,
                  max_grad_norm=args.max_grad_norm,
                  remat=args.gradient_checkpointing)
    if args.method == "sft":
        from visionselector_tpu_torch.train.sft import (
            SFTScheduleConfig,
            init_sft_state,
            sft_train_step_accum,
        )

        if args.lora_rank > 0:
            from visionselector_tpu_torch.train.lora import add_lora_params

            add_lora_params(params.lm, torch.Generator(
                device=dev).manual_seed(args.seed + 1), rank=args.lora_rank,
                alpha=args.lora_alpha)
        sched = SFTScheduleConfig(
            tune_mm_vision=args.tune_mm_vision, tune_mm_mlp=args.tune_mm_mlp,
            tune_mm_llm=args.tune_mm_llm, lora_rank=args.lora_rank,
            **common)
        state = init_sft_state(params, sched)

        def step_fn(state, micro):
            return sft_train_step_accum(state, params, micro, cfg, sched)
    elif args.method == "dynamic":
        from visionselector_tpu_torch.selector.baselines.dynamic import (
            init_predictor,
        )
        from visionselector_tpu_torch.train.dynamic_train import (
            DynamicScheduleConfig,
            dynamic_train_step_accum,
            init_dynamic_train_state,
        )

        sched = DynamicScheduleConfig(
            tau_start=args.tau_start, tau_end=args.tau_end,
            budget=args.budget, mask_loss_weight=args.mask_loss_weight,
            **common)
        # sized to the LM's hidden width (the reference's VisionPredictor
        # input_dim, dynamic_model.py:302); narrow for the tiny config
        d_model = 64 if tiny else 512
        predictor = init_predictor(
            cfg.text.hidden_size, torch.Generator(device=dev).manual_seed(
                args.seed), dev, d_model=d_model,
            num_heads=8 if d_model >= 512 else 4)
        state = init_dynamic_train_state(params, predictor, sched,
                                         seed=args.seed)

        def step_fn(state, micro):
            return dynamic_train_step_accum(state, params, micro, cfg, sched)
    else:
        from visionselector_tpu_torch.train.train_step import (
            ScheduleConfig,
            init_train_state,
            train_step_accum,
        )

        sched = ScheduleConfig(reg_weight_start=args.reg_weight_start,
                               reg_weight_end=args.reg_weight_end, **common)
        state = init_train_state(params, sched)

        def step_fn(state, micro):
            return train_step_accum(state, params, micro, cfg, k_max, sched)
    state, resumed = maybe_resume(args.output_dir, state)
    if resumed:
        print(f"[train] resumed at step {state.step}")

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
    saver = AsyncSaver() if args.async_save else None
    t0 = time.time()
    try:
        while state.step < args.total_steps:
            state, metrics = step_fn(state, next(batch_iter))
            step = state.step
            if step % args.log_steps == 0 or step == args.total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, wall_s=round(time.time() - t0, 1))
                print(json.dumps(m))
                with open(log_path, "a") as f:
                    f.write(json.dumps(m) + "\n")
            if step % args.save_steps == 0 or step == args.total_steps:
                path = save_train_state(state, args.output_dir, step=step,
                                        saver=saver)
                print(f"[train] saved {path}"
                      + (" (async)" if saver is not None else ""))
    finally:
        # stop the prefetch thread even when a step raises, and join the
        # write in flight before the exports (or the exception) go on
        if prefetcher is not None:
            prefetcher.close()
        if saver is not None:
            saver.finalize_saves()

    out = args.output_dir
    if args.method == "dynamic":
        from visionselector_tpu_torch.train.dynamic_train import (
            export_predictor_to_safetensors,
        )

        export_predictor_to_safetensors(
            state.predictor,
            os.path.join(out, "image_score_predictor.safetensors"))
        print(f"[train] exported predictor to {out}")
    elif args.method == "sft":
        if args.lora_rank > 0:
            # the adapters folded into the dense kernels (the reference's
            # merge_lora_weights.py flow), the whole model written
            from visionselector_tpu_torch.core.checkpoint import save_params
            from visionselector_tpu_torch.train.lora import merge_lora_params

            merge_lora_params(params.lm)
            path = save_params(params, os.path.join(out, "lora_merged"))
            print(f"[train] LoRA merged into {path}")
        # the trained parameters live in the checkpoint-<step> dirs
        print(f"[train] SFT checkpoints in {out}")
    else:
        from visionselector_tpu_torch.models.qwen25vl.weights import (
            export_scorer_to_safetensors,
        )

        export_scorer_to_safetensors(
            state.scorer, os.path.join(out, "importance_scorer.safetensors"),
            prefix=scorer_prefix)
        print(f"[train] exported scorer to {out}")
    _copy_loader_configs(args.model_path, out)
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
