"""Training CLI for the PyTorch port (the reference's
``train_qwen_selector.py`` + ``scripts/sft_3b.sh``, ``train_qwen_dynamic.py``,
``train_qwen.py``, the OV trainers, ``train_dpo.py`` and
``train_grpo.py``; counterpart of ``visionselector_tpu.api.train``).

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
        [--method dynamic | --method sft|dpo|grpo [--lora-rank 8]] \\
        [--async-save]

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
- ``dpo``: preference optimization against the frozen starting policy
  (``train.dpo``: ``--beta``, ``--dpo-loss-type sigmoid|ipo``,
  ``--rpo-alpha``, ``--label-smoothing``); ``--annotation`` records carry
  ``prompt`` (or ``conversations``) / ``chosen`` / ``rejected``.
- ``grpo``: sampled-rollout RL with group-relative advantages
  (``train.grpo``: ``--num-generations`` rollouts per prompt through the
  serving engine on the current policy, ``--temperature``,
  ``--max-completion-length``, ``--grpo-beta`` KL weight,
  ``--grpo-loss-type grpo|bnpo|dr_grpo``, ``--rewards``); records carry
  ``prompt`` (or ``conversations``) / ``solution``. ``mean_reward`` is
  logged.
``sft``, ``dpo`` and ``grpo`` train under the same freeze policy or, with
``--lora-rank``, LoRA adapters merged at the end into
``lora_merged/params.pt``.

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

Data parallelism (the reference's ``(n_data, 1)`` mesh over its devices):
started by ``torch.distributed.run``, or with a default process group
already made, every rank trains on its part of each batch::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m visionselector_tpu_torch.api.train --batch-size 8 ...

The mesh is ``mesh.data_mesh``: n_data = gcd(batch size, world) ranks,
the rest idle (one line on stderr, exit 0). Every rank builds the same
seeded global batch stream and keeps its part (``mesh.batch_sharding``;
under ``--method grpo`` it rolls out only its own prompts, with the
global seeds); ``train_step.accumulate`` averages the gradients and the
metrics over the ranks, so every rank takes the same step. Devices and
backend from ``mesh.placement`` (NCCL with a card per rank, else gloo on
``cuda:0``). Only rank 0 writes ``train_log.jsonl``, the checkpoints and
the exports; every rank resumes from the same checkpoint.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

LORA_METHODS = ("sft", "dpo", "grpo")


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
    # DPO (the reference's dpo_trainer.py / trl surface)
    p.add_argument("--beta", type=float, default=0.1,
                   help="--method dpo: the DPO temperature")
    p.add_argument("--dpo-loss-type", default="sigmoid",
                   choices=("sigmoid", "ipo"))
    p.add_argument("--rpo-alpha", type=float, default=0.0,
                   help="--method dpo: > 0 adds alpha * CE(chosen)")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    # GRPO (the reference's grpo_trainer.py / trl surface)
    p.add_argument("--grpo-beta", type=float, default=0.04,
                   help="--method grpo: KL-to-reference weight (0 skips "
                        "the reference forward)")
    p.add_argument("--num-generations", type=int, default=4)
    p.add_argument("--temperature", type=float, default=1.0,
                   help="--method grpo: the rollouts' sampling temperature")
    p.add_argument("--max-completion-length", type=int, default=64)
    p.add_argument("--grpo-loss-type", default="grpo",
                   choices=("grpo", "bnpo", "dr_grpo"))
    p.add_argument("--rewards", default="accuracy,format",
                   help="--method grpo: comma list of train.grpo."
                        "REWARD_FUNCS")
    p.add_argument("--tau-start", type=float, default=1.0,
                   help="--method dynamic: Gumbel temperature at step 0")
    p.add_argument("--tau-end", type=float, default=0.1,
                   help="--method dynamic: temperature at the last step")
    p.add_argument("--mask-loss-weight", type=float, default=100.0,
                   help="--method dynamic: weight of the keep-ratio MSE")
    # SFT freeze policy (the reference's tune_mm_* knobs); --tune-mm-llm is
    # on by default (an all-frozen SFT trains nothing).
    p.add_argument("--tune-mm-vision", action="store_true",
                   help="--method sft|dpo|grpo: train the vision tower")
    p.add_argument("--tune-mm-mlp", action="store_true",
                   help="--method sft|dpo|grpo: train the patch merger")
    p.add_argument("--tune-mm-llm", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--method sft|dpo|grpo: train the decoder")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="--method sft|dpo|grpo: > 0 trains LoRA adapters "
                        "of this rank on the decoder's kernels instead")
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


def _check_options(args) -> None:
    """ValueError for a combination the reference ignores without a word
    or asserts against."""
    is_ov = args.family == "llava_ov15"
    if args.data_flatten and is_ov:
        raise ValueError("--data-flatten packs Qwen2.5-VL rows only (the "
                         "reference ignores it for --family llava_ov15)")
    if args.data_flatten and not args.annotation:
        raise ValueError("--data-flatten packs --annotation records")
    if args.method == "dynamic" and is_ov:
        raise ValueError("--method dynamic trains the Qwen2.5-VL family's "
                         "predictor only")
    if args.lora_rank > 0 and args.method not in LORA_METHODS:
        raise ValueError("--lora-rank trains adapters under --method sft, "
                         "dpo or grpo")
    if args.method == "grpo":
        if args.num_generations < 2:
            raise ValueError("--method grpo needs --num-generations >= 2 "
                             "for a relative advantage")
        if args.grad_accum_steps > 1 and args.grpo_loss_type != "grpo":
            raise ValueError(
                "--grad-accum-steps > 1 under --method grpo takes the "
                "per-sequence-mean 'grpo' reduction (bnpo / dr_grpo weight "
                "by the whole batch's token counts)")


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
    _check_options(args)
    import torch
    import torch.distributed as dist

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    owned = _join_world(args)
    try:
        return _train(args)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _join_world(args) -> bool:
    """Join the default process group over ``env://`` when
    ``torch.distributed.run`` started this process (WORLD_SIZE > 1) and
    none exists yet. True when it joined (``main`` leaves it at the
    end)."""
    import torch.distributed as dist

    from visionselector_tpu_torch.core.mesh import init_world, placement

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized() or world <= 1:
        return False
    rank = int(os.environ["RANK"])
    _, backend = placement(args.device,
                           int(os.environ.get("LOCAL_RANK", rank)), world)
    init_world(rank, world, "env://", backend)
    return True


def _data_mesh(args):
    """(this rank's data mesh or None, rank 0?, idle?) in the default
    process group, if one exists (``mesh.data_mesh``)."""
    import torch
    import torch.distributed as dist

    from visionselector_tpu_torch.core.mesh import data_mesh, placement

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None, True, False
    rank, world = dist.get_rank(), dist.get_world_size()
    device, _ = placement(args.device,
                          int(os.environ.get("LOCAL_RANK", rank)), world)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # "cuda" below is this rank's card
    mesh = data_mesh(args.batch_size, device=device)
    if mesh is None:
        print(f"[train] rank {rank} idle: the mesh takes gcd(batch size "
              f"{args.batch_size}, world {world}) ranks", file=sys.stderr)
        return None, False, True
    if rank == 0:
        print(f"[train] data parallel over {mesh.size('data')} of {world} "
              f"ranks, backend {mesh.backend}, rank 0 on {mesh.device}")
    return mesh, rank == 0, False


def _train(args) -> int:
    """This process's training run (``main`` has joined the world, if
    any; see the module docstring)."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.api.predict import load_model
    from visionselector_tpu_torch.core.checkpoint import (
        AsyncSaver,
        maybe_resume,
        save_train_state,
    )
    from visionselector_tpu_torch.core.mesh import batch_sharding
    from visionselector_tpu_torch.core.params import init_random_
    from visionselector_tpu_torch.selector.scorer import Scorer
    from visionselector_tpu_torch.train.data import stack_samples
    from visionselector_tpu_torch.train.loss import to_device

    dev = args.device
    mesh, lead, idle = _data_mesh(args)
    if idle:
        return 0
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
            if args.data_flatten:  # the Qwen family (_check_options)
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

    def records():
        """The --annotation records (a json list or jsonl), cycled."""
        with open(args.annotation) as f:
            head = f.read(1)
            f.seek(0)
            recs = (json.load(f) if head == "["
                    else [json.loads(ln) for ln in f if ln.strip()])
        i = 0
        while True:
            yield recs[i % len(recs)]
            i += 1

    def dpo_pair_stream():
        """(chosen, rejected) samples: the --annotation preference
        records, else synthetic pairs (one prompt, two completions)."""
        if args.annotation:
            from visionselector_tpu_torch.train.dpo import (
                build_dpo_pair_from_record,
            )

            tok = _tokenizer(args.model_path)
            for rec in records():
                yield build_dpo_pair_from_record(
                    cfg, rec, tok, args.budget, args.vision_bucket,
                    args.text_bucket, image_root=args.image_root,
                    family=args.family)
            return
        if is_ov:
            from visionselector_tpu_torch.train.ov_loss import (
                build_ov_train_sample as build,
            )
        else:
            from visionselector_tpu_torch.train.data import (
                build_train_sample as build,
            )
        rng = np.random.RandomState(args.seed)
        kw = dict(budget=args.budget, s_bucket=args.vision_bucket,
                  t_bucket=args.text_bucket, min_pixels=1, max_pixels=10**9)
        while True:
            img = (rng.rand(56, 56, 3) * 255).astype(np.uint8)
            yield (build(cfg, img, [101, 102], [103], [201, 202, 203], **kw),
                   build(cfg, img, [101, 102], [103], [301, 302], **kw))

    def grpo_prompt_stream():
        """(images, raw prompt ids, image slots in them, solution text or
        None, tokenizer or None): the --annotation records' prompts with
        the assistant turn opened, else a synthetic one-image prompt."""
        if args.annotation:
            from PIL import Image

            from visionselector_tpu_torch.train.dataset import (
                IM_START,
                render_conversation,
            )

            tok = _tokenizer(args.model_path)
            for rec in records():
                if "conversations" in rec:
                    convo = list(rec["conversations"])
                    if convo and convo[-1].get(
                            "from", convo[-1].get("role")) in (
                            "gpt", "assistant"):
                        convo = convo[:-1]
                else:
                    prompt = rec["prompt"]
                    if "<image>" not in prompt and rec.get("image"):
                        prompt = "<image>" + prompt
                    convo = [{"from": "human", "value": prompt}]
                ids, _, slots = render_conversation(convo, tok)
                # generation starts on the template's assistant turn (the
                # reference's add_generation_prompt=True)
                ids = ids + tok.encode(f"{IM_START}assistant\n")
                paths = rec.get("image") or []
                paths = paths if isinstance(paths, list) else [paths]
                if not slots or len(paths) != len(slots):
                    raise ValueError(
                        f"GRPO records need one image per <image> "
                        f"placeholder, at least one: {len(paths)} images, "
                        f"{len(slots)} placeholders")
                images = []
                for path in paths:
                    with Image.open(os.path.join(args.image_root,
                                                 path)) as im:
                        images.append(im.convert("RGB").copy())
                yield (images, ids, slots,
                       rec.get("solution", rec.get("answer", "")), tok)
            return
        rng = np.random.RandomState(args.seed)
        while True:
            img = (rng.rand(56, 56, 3) * 255).astype(np.uint8)
            yield [img], [101, 102, 103], [2], None, None

    l_pad = args.vision_bucket // cfg.vision.spatial_merge_unit
    k_max = max(1, int(l_pad * args.budget))
    common = dict(total_steps=args.total_steps, lr=args.lr,
                  weight_decay=args.weight_decay,
                  warmup_ratio=args.warmup_ratio,
                  max_grad_norm=args.max_grad_norm,
                  remat=args.gradient_checkpointing)
    accum = max(1, args.grad_accum_steps)
    stream = None
    if args.lora_rank > 0:  # sft, dpo or grpo (_check_options)
        from visionselector_tpu_torch.train.lora import add_lora_params

        add_lora_params(params.lm, torch.Generator(device=dev).manual_seed(
            args.seed + 1), rank=args.lora_rank, alpha=args.lora_alpha)
    freeze = dict(tune_mm_vision=args.tune_mm_vision,
                  tune_mm_mlp=args.tune_mm_mlp, tune_mm_llm=args.tune_mm_llm,
                  lora_rank=args.lora_rank)
    if args.method == "sft":
        from visionselector_tpu_torch.train.sft import (
            SFTScheduleConfig,
            init_sft_state,
            sft_train_step_accum,
        )

        sched = SFTScheduleConfig(**freeze, **common)
        state = init_sft_state(params, sched)

        def step_fn(state, micro):
            return sft_train_step_accum(state, params, micro, cfg, sched)
    elif args.method == "dpo":
        from visionselector_tpu_torch.train.dpo import (
            DPOScheduleConfig,
            ReferencePolicy,
            dpo_train_step_accum,
            init_dpo_state,
        )

        sched = DPOScheduleConfig(
            beta=args.beta, loss_type=args.dpo_loss_type,
            rpo_alpha=args.rpo_alpha, label_smoothing=args.label_smoothing,
            **freeze, **common)
        state = init_dpo_state(params, sched)
        # the starting weights, also after a resume (taken before it)
        ref = ReferencePolicy(params, state)
        stream = dpo_pair_stream()

        def step_fn(state, micro):
            return dpo_train_step_accum(
                state, ref, params, [c for c, _ in micro],
                [r for _, r in micro], cfg, sched)
    elif args.method == "grpo":
        from visionselector_tpu_torch.train.dpo import ReferencePolicy
        from visionselector_tpu_torch.train.grpo import (
            GRPOScheduleConfig,
            init_grpo_state,
        )

        sched = GRPOScheduleConfig(
            beta=args.grpo_beta, loss_type=args.grpo_loss_type,
            num_generations=args.num_generations,
            temperature=args.temperature,
            max_completion_length=args.max_completion_length,
            **freeze, **common)
        state = init_grpo_state(params, sched)
        ref = ReferencePolicy(params, state) if sched.beta > 0 else None
        stream = grpo_prompt_stream()
        step_fn = _grpo_stepper(args, cfg, params, ref, sched, stream, dev,
                                accum, tiny, mesh)
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
    state.mesh = mesh
    state, resumed = maybe_resume(args.output_dir, state)
    if resumed and lead:
        print(f"[train] resumed at step {state.step}")

    if stream is None:
        stream = sample_stream()
    local = None if mesh is None else batch_sharding(mesh)

    def part(batch):
        """This rank's part of a stacked host batch."""
        return batch if local is None else type(batch)(*map(local, batch))

    def micro_batch():
        """``batch-size`` samples (pairs under dpo), this rank's part on
        the device."""
        items = [next(stream) for _ in range(args.batch_size)]
        if args.method == "dpo":
            return tuple(to_device(part(stack_samples([it[i] for it in
                                                       items])), dev)
                         for i in range(2))
        return to_device(part(stack_samples(items)), dev)

    def next_batch():
        """``accum`` micro-batches, on the device."""
        return [micro_batch() for _ in range(accum)]

    prefetcher = None
    if args.method == "grpo":
        # rollouts sample the CURRENT policy: nothing is built ahead
        batch_iter = itertools.repeat(None)
    elif args.prefetch > 0:
        from visionselector_tpu_torch.train.prefetch import BatchPrefetcher

        prefetcher = batch_iter = BatchPrefetcher(next_batch,
                                                  size=args.prefetch)
    else:
        batch_iter = iter(next_batch, None)

    if lead:
        os.makedirs(args.output_dir, exist_ok=True)
    log_path = os.path.join(args.output_dir, "train_log.jsonl")
    saver = AsyncSaver() if args.async_save and lead else None
    t0 = time.time()
    try:
        while state.step < args.total_steps:
            state, metrics = step_fn(state, next(batch_iter))
            step = state.step
            if not lead:
                continue
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
    if not lead:
        return 0
    if args.method == "dynamic":
        from visionselector_tpu_torch.train.dynamic_train import (
            export_predictor_to_safetensors,
        )

        export_predictor_to_safetensors(
            state.predictor,
            os.path.join(out, "image_score_predictor.safetensors"))
        print(f"[train] exported predictor to {out}")
    elif args.method in LORA_METHODS:
        if args.lora_rank > 0:
            # the adapters folded into the dense kernels (the reference's
            # merge_lora_weights.py flow), the whole model written
            from visionselector_tpu_torch.core.checkpoint import save_params
            from visionselector_tpu_torch.train.lora import merge_lora_params

            merge_lora_params(params.lm)
            path = save_params(params, os.path.join(out, "lora_merged"))
            print(f"[train] LoRA merged into {path}")
        # the trained parameters live in the checkpoint-<step> dirs
        print(f"[train] {args.method.upper()} checkpoints in {out}")
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


def _grpo_stepper(args, cfg, params, ref, sched, stream, dev, accum: int,
                  tiny: bool, mesh=None):
    """``step_fn(state, _)`` of ``--method grpo``: per prompt,
    ``num_generations`` rollouts through the serving engine on the current
    policy (the engine holds the very modules AdamW updates, adapters
    included, and caches no weight: no prefix store, the default
    attention), the rewards and group advantages, the samples that
    supervise exactly the sampled tokens, then one update
    (``grpo_train_step``, or ``grpo_train_step_accum`` over ``accum``
    micro-batches). Prompt ``bi`` of micro-batch ``a`` at update n rolls
    out with seed ``(n * batch_size * accum) + a * batch_size + bi``.
    Rollouts and the scored samples share one pixel-bound policy, so the
    completions are conditioned on exactly the grid the step scores.
    Under data parallelism (``mesh``) each rank takes every prompt from
    the stream but rolls out only its own part of each micro-batch, with
    the global seeds; ``mean_reward`` is averaged over the ranks."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import (
        expand_vision_tokens_at_slots,
    )
    from visionselector_tpu_torch.train.data import stack_samples
    from visionselector_tpu_torch.train.grpo import (
        REWARD_FUNCS,
        build_grpo_sample,
        group_advantages,
        grpo_train_step,
        grpo_train_step_accum,
        rollout_group,
    )
    from visionselector_tpu_torch.train.loss import to_device
    from visionselector_tpu_torch.train.train_step import (
        data_mean,
        data_parallel,
    )

    if args.family == "llava_ov15":
        from visionselector_tpu_torch.models.llava_ov15.model import OVEngine

        engine = OVEngine(cfg, params, use_selector=False, device=dev)
    else:
        from visionselector_tpu_torch.models.qwen25vl.model import (
            QwenVLEngine,
        )

        engine = QwenVLEngine(cfg, params, use_selector=False, device=dev)
    mm = (dict(min_pixels=1, max_pixels=10**9) if tiny
          else dict(min_pixels=56 * 56, max_pixels=28 * 28 * 1280))
    reward_fns = [REWARD_FUNCS[n] for n in args.rewards.split(",") if n]
    vc = cfg.vision
    own = range(args.batch_size)  # this rank's prompts of a micro-batch
    if data_parallel(mesh):
        per = args.batch_size // mesh.size("data")
        own = range(mesh.index("data") * per,
                    (mesh.index("data") + 1) * per)

    def one_micro(seed_base):
        samples, rewards = [], []
        for bi in range(args.batch_size):
            images, raw_ids, slots, solution, tok = next(stream)
            if bi not in own:
                continue
            prepped = [preprocess_image(
                im, patch_size=vc.patch_size,
                temporal_patch_size=vc.temporal_patch_size,
                merge_size=vc.spatial_merge_size, **mm) for im in images]
            pixels = np.concatenate([px for px, _ in prepped], axis=0)
            grid = np.concatenate([g for _, g in prepped], axis=0)
            ids = expand_vision_tokens_at_slots(
                raw_ids, slots, grid, spatial_merge_size=vc.spatial_merge_size,
                image_token_id=cfg.image_token_id,
                vision_start_token_id=cfg.vision_start_token_id,
                vision_end_token_id=cfg.vision_end_token_id)
            comps = rollout_group(engine, ids, pixels, grid, sched,
                                  seed=seed_base + bi)
            if tok is not None:
                texts = [tok.decode(c, skip_special_tokens=True)
                         for c in comps]
                per_fn = [fn(texts, solution=[solution] * len(texts))
                          for fn in reward_fns]
                rewards.extend(float(sum(col)) for col in zip(*per_fn))
            else:
                # synthetic reward: the parity of the completion's token
                # sum, which varies across a group
                rewards.extend(float(int(np.sum(c)) % 2 == 0)
                               for c in comps)
            samples.extend(build_grpo_sample(
                cfg, images, raw_ids, slots, c, budget=args.budget,
                s_bucket=args.vision_bucket, t_bucket=args.text_bucket,
                family=args.family, **mm) for c in comps)
        adv = group_advantages(np.asarray(rewards), sched.num_generations,
                               sched.scale_rewards)
        return (to_device(stack_samples(samples), dev),
                torch.as_tensor(adv, device=dev), rewards)

    def step_fn(state, _):
        base = state.step * args.batch_size * accum
        micros = [one_micro(base + a * args.batch_size)
                  for a in range(accum)]
        if accum == 1:
            state, metrics = grpo_train_step(
                state, ref, params, micros[0][0], micros[0][1], cfg, sched)
        else:
            state, metrics = grpo_train_step_accum(
                state, ref, params, [b for b, _, _ in micros],
                [a for _, a, _ in micros], cfg, sched)
        mean_reward = {"mean_reward": float(np.mean(
            [r for _, _, rs in micros for r in rs]))}
        if data_parallel(mesh):
            mean_reward = data_mean(mesh, [], mean_reward)
        metrics.update(mean_reward)
        return state, metrics

    return step_fn


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
