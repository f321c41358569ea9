"""Conversation dataset for selector training.

The port's copy of the JAX-free parts of ``visionselector_tpu.train.
dataset`` (the reference data layer, ``qwen-vl-finetune/qwenvl/data/``):

- dataset registry with ``%NN`` sampling-rate suffix parsing,
- jsonl "conversations" records -> chat-templated token ids, only the
  assistant turns supervised, with each ``<image>`` placeholder's offset
  returned as a slot for its vision tokens,
- 3-retry + neighbour-fallback ``__getitem__``,
- ``build_sample_from_record``: a record -> ``TrainBatchSample`` (one or
  several images, or a video at its ``<video>`` placeholder),
- sequence packing (``--data-flatten``): ``build_packed_train_sample``
  puts several one-image records in one row with distinct segment ids,
  the port's counterpart of the reference's flattened collator;
  ``pack_text_samples`` plans first-fit groups by length.

The tokenizer is passed in (``encode(text) -> ids``); nothing here
imports ``transformers``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from visionselector_tpu_torch.preprocess.image import preprocess_image
from visionselector_tpu_torch.preprocess.indices import build_vision_batch
from visionselector_tpu_torch.preprocess.rope import get_rope_index
from visionselector_tpu_torch.preprocess.video import process_video
from visionselector_tpu_torch.train.data import vision_fields
from visionselector_tpu_torch.train.loss import IGNORE_INDEX, TrainBatchSample

logger = logging.getLogger(__name__)

SYSTEM_PROMPT = "You are a helpful assistant."
IM_START = "<|im_start|>"
IM_END = "<|im_end|>"


@dataclasses.dataclass
class DatasetSpec:
    name: str
    annotation_path: str
    data_path: str  # image root
    sampling_rate: float = 1.0


def parse_dataset_names(spec: str,
                        registry: Dict[str, Dict[str, str]]
                        ) -> List[DatasetSpec]:
    """'coco%10,chartqa' -> specs with sampling rates."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        rate = 1.0
        if "%" in item:
            item, pct = item.split("%")
            rate = float(pct) / 100.0
        entry = registry[item]
        out.append(DatasetSpec(item, entry["annotation_path"],
                               entry.get("data_path", ""), rate))
    return out


def render_conversation(
    conversations: Sequence[dict],
    tokenizer,
) -> Tuple[List[int], List[int], List[int]]:
    """Chat-template a conversations list into (input_ids, labels, slots):
    system turn, then user / assistant turns, only assistant responses
    supervised. Each ``<image>`` / ``<video>`` placeholder's token offset
    is a slot where its vision tokens go.

    Returns: (ids WITHOUT vision expansion, labels aligned to ids,
    ascending offsets into ids for the vision blocks; empty for text-only
    records).
    """
    ids: List[int] = []
    labels: List[int] = []
    slots: List[int] = []

    def add(text: str, supervised: bool):
        toks = tokenizer.encode(text)
        ids.extend(toks)
        labels.extend(toks if supervised else [IGNORE_INDEX] * len(toks))

    add(f"{IM_START}system\n{SYSTEM_PROMPT}{IM_END}\n", False)
    for turn in conversations:
        role = turn.get("from", turn.get("role", "human"))
        value = turn.get("value", turn.get("content", ""))
        if role in ("human", "user"):
            add(f"{IM_START}user\n", False)
            rest = value
            while "<image>" in rest or "<video>" in rest:
                ii = rest.find("<image>")
                vi = rest.find("<video>")
                if ii < 0 or (0 <= vi < ii):
                    idx, tag = vi, "<video>"
                else:
                    idx, tag = ii, "<image>"
                add(rest[:idx], False)
                slots.append(len(ids))
                rest = rest[idx + len(tag):]
            add(f"{rest}{IM_END}\n", False)
        else:
            add(f"{IM_START}assistant\n", False)
            add(f"{value}{IM_END}\n", True)
    return ids, labels, slots


class ConversationDataset:
    """Lazy jsonl (or json list) conversation dataset with retry and
    neighbour fallback."""

    def __init__(self, annotation_path: str, data_path: str, tokenizer,
                 sampling_rate: float = 1.0, seed: int = 0,
                 max_retries: int = 3):
        with open(annotation_path) as f:
            if annotation_path.endswith(".jsonl"):
                self.records = [json.loads(ln) for ln in f if ln.strip()]
            else:
                self.records = json.load(f)
        if sampling_rate < 1.0:
            rng = random.Random(seed)
            keep = max(1, int(len(self.records) * sampling_rate))
            self.records = rng.sample(self.records, keep)
        self.data_path = data_path
        self.tokenizer = tokenizer
        self.max_retries = max_retries

    def __len__(self):
        return len(self.records)

    def _load(self, idx: int):
        rec = self.records[idx]
        ids, labels, slots = render_conversation(
            rec["conversations"], self.tokenizer)
        # "image": str | [str, ...], one vision block per image
        images = []
        img_names = rec.get("image")
        if img_names:
            from PIL import Image

            names = (img_names if isinstance(img_names, list)
                     else [img_names])
            for nm in names:
                im = Image.open(os.path.join(self.data_path, nm))
                im.load()
                images.append(im)
        video = rec.get("video")
        return {"ids": ids, "labels": labels,
                "image_slot": slots[0] if slots else -1,
                "image_slots": slots,
                "image": images[0] if images else None,
                "images": images, "id": rec.get("id", idx),
                "video": (os.path.join(self.data_path, video)
                          if video else None)}

    def __getitem__(self, idx: int):
        """3 retries, then the nearest loadable neighbour."""
        for attempt in range(self.max_retries):
            try:
                return self._load(idx)
            except Exception as e:  # noqa: BLE001 - a bad record is skipped
                logger.warning("sample %d failed (try %d): %s", idx, attempt,
                               e)
        for delta in range(1, len(self.records)):
            for j in ((idx + delta) % len(self), (idx - delta) % len(self)):
                try:
                    return self._load(j)
                except Exception:  # noqa: BLE001
                    continue
        raise RuntimeError("no loadable sample in dataset")


def build_sample_from_record(
    cfg,
    record: dict,
    budget: float,
    s_bucket: int,
    t_bucket: int,
    min_pixels: int = 56 * 56,
    max_pixels: int = 28 * 28 * 1280,
    align_windows: bool = True,
) -> TrainBatchSample:
    """Dataset record -> TrainBatchSample: each image's vision tokens
    spliced at its slot, or a video record's (``record["video"]``, read by
    ``preprocess.video.process_video`` with the pixel bounds) at its
    ``<video>`` slot, as ``<|video_pad|>`` tokens with the clip's
    ``second_per_grid_t`` in the M-RoPE ids."""
    ids = list(record["ids"])
    labels = list(record["labels"])
    slot = record["image_slot"]
    is_video = record.get("video") is not None
    if (record["image"] is None and not is_video) or slot < 0:
        raise ValueError("text-only records are not built into samples")
    spg = None
    if is_video:
        pixels, grid, spg = process_video(
            record["video"],
            ele={"min_pixels": min_pixels, "max_pixels": max_pixels},
            patch_size=cfg.vision.patch_size,
            temporal_patch_size=cfg.vision.temporal_patch_size,
            merge_size=cfg.vision.spatial_merge_size,
        )
        px_list, slots = [pixels], [slot]
    else:
        images = record.get("images") or [record["image"]]
        slots = record.get("image_slots") or [slot]
        if len(images) != len(slots):
            raise ValueError(f"{len(images)} images for {len(slots)} slots")
        px_list, g_list = [], []
        for im in images:
            px_i, g_i = preprocess_image(
                im, min_pixels=min_pixels, max_pixels=max_pixels,
                patch_size=cfg.vision.patch_size,
                temporal_patch_size=cfg.vision.temporal_patch_size,
                merge_size=cfg.vision.spatial_merge_size,
            )
            px_list.append(px_i)
            g_list.append(g_i)
        pixels = np.concatenate(px_list, axis=0)
        grid = np.concatenate(g_list, axis=0)
    vb = build_vision_batch(
        pixels, grid,
        window_size=cfg.vision.window_size,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        patch_size=cfg.vision.patch_size,
        pad_to=s_bucket,
        align_windows=align_windows,
    )
    n = vb.num_merged
    l_pad = s_bucket // cfg.vision.spatial_merge_unit

    vision_token = cfg.video_token_id if is_video else cfg.image_token_id
    mu = cfg.vision.spatial_merge_unit
    run_lens = [px.shape[0] // mu for px in px_list]
    if list(slots) != sorted(slots):
        raise ValueError(f"image slots must ascend, got {slots}")
    id_parts, label_parts = [], []
    prev = 0
    for sl, n_i in zip(slots, run_lens):
        run = ([cfg.vision_start_token_id] + [vision_token] * n_i
               + [cfg.vision_end_token_id])
        id_parts += ids[prev:sl] + run
        label_parts += labels[prev:sl] + [IGNORE_INDEX] * len(run)
        prev = sl
    full_ids = np.asarray(id_parts + ids[prev:], np.int64)
    full_labels = np.asarray(label_parts + labels[prev:], np.int64)
    t_real = len(full_ids)
    if t_real > t_bucket:
        raise ValueError(f"record of {t_real} tokens exceeds the text "
                         f"bucket {t_bucket}")

    position_ids, _ = get_rope_index(
        full_ids,
        image_grid_thw=None if is_video else grid,
        video_grid_thw=grid if is_video else None,
        second_per_grid_ts=np.array([spg]) if is_video else None,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        tokens_per_second=cfg.vision.tokens_per_second,
        image_token_id=cfg.image_token_id,
        video_token_id=cfg.video_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
    )

    ids_p = np.zeros(t_bucket, np.int64)
    ids_p[:t_real] = full_ids
    lab_p = np.full(t_bucket, IGNORE_INDEX, np.int64)
    lab_p[:t_real] = full_labels
    pos_p = np.zeros((3, t_bucket), np.int64)
    pos_p[:, :t_real] = position_ids
    seg = np.zeros(t_bucket, np.int32)
    seg[:t_real] = 1
    image_pos = np.where(ids_p == vision_token)[0][:n]
    image_pos_p = np.full(l_pad, t_bucket, np.int64)
    image_pos_p[:n] = image_pos

    return TrainBatchSample(
        num_merged=np.asarray(n, np.int32),
        k=np.asarray(max(1, int(n * budget)), np.int32),
        input_ids=ids_p,
        labels=lab_p,
        position_ids=pos_p,
        seg_ids=seg,
        image_positions=image_pos_p,
        **vision_fields(vb),
    )


def build_packed_train_sample(
    cfg,
    records: List[dict],
    budget: float,
    s_bucket: int,
    t_bucket: int,
    min_pixels: int = 56 * 56,
    max_pixels: int = 28 * 28 * 1280,
    align_windows: bool = True,
) -> TrainBatchSample:
    """Pack several one-image records into ONE ``TrainBatchSample`` row
    (``visionselector_tpu.train.dataset.build_packed_train_sample``):

    - sample i (1-based) gets segment id i, so the decoder's causal
      attention stays inside each sample, and its M-RoPE ids restart at 0;
    - all the row's images go through one multi-image vision batch (the
      window-aligned layout by default; ``align_windows=False`` gives the
      reference's classic one), the selection runs jointly over the row's
      merged tokens with ``k = max(1, int(budget * n_total))``;
    - each sample's first label is IGNORE_INDEX (no loss across a sample
      boundary).

    Raises ValueError where the reference asserts: a record without an
    image slot, a record of several images (route it through
    ``build_sample_from_record``), or a row longer than ``t_bucket``.
    """
    all_pixels, all_grids = [], []
    ids_parts, label_parts, pos_parts, seg_parts = [], [], [], []
    for si, rec in enumerate(records):
        if rec["image"] is None or rec["image_slot"] < 0:
            raise ValueError("packed rows take image records only")
        if len(rec.get("images") or [rec["image"]]) != 1:
            raise ValueError(
                "packed rows splice one image per record; route "
                "multi-image records through build_sample_from_record")
        pixels, grid = preprocess_image(
            rec["image"], min_pixels=min_pixels, max_pixels=max_pixels,
            patch_size=cfg.vision.patch_size,
            temporal_patch_size=cfg.vision.temporal_patch_size,
            merge_size=cfg.vision.spatial_merge_size,
        )
        all_pixels.append(pixels)
        all_grids.append(grid)
        n_i = pixels.shape[0] // cfg.vision.spatial_merge_unit
        vision_ids = ([cfg.vision_start_token_id]
                      + [cfg.image_token_id] * n_i
                      + [cfg.vision_end_token_id])
        slot = rec["image_slot"]
        ids_i = np.asarray(rec["ids"][:slot] + vision_ids
                           + rec["ids"][slot:], np.int64)
        labels_i = np.asarray(rec["labels"][:slot]
                              + [IGNORE_INDEX] * len(vision_ids)
                              + rec["labels"][slot:], np.int64)
        labels_i[0] = IGNORE_INDEX  # nothing predicted across the boundary
        pos_i, _ = get_rope_index(
            ids_i, image_grid_thw=grid,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            tokens_per_second=cfg.vision.tokens_per_second,
            image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
        )
        ids_parts.append(ids_i)
        label_parts.append(labels_i)
        pos_parts.append(pos_i)
        seg_parts.append(np.full(len(ids_i), si + 1, np.int32))

    vb = build_vision_batch(
        np.concatenate(all_pixels), np.concatenate(all_grids),
        window_size=cfg.vision.window_size,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        patch_size=cfg.vision.patch_size,
        pad_to=s_bucket,
        align_windows=align_windows,
    )
    n = vb.num_merged
    l_pad = s_bucket // cfg.vision.spatial_merge_unit
    full_ids = np.concatenate(ids_parts)
    t_real = len(full_ids)
    if t_real > t_bucket:
        raise ValueError(f"packed row of {t_real} tokens exceeds the text "
                         f"bucket {t_bucket}")

    ids_p = np.zeros(t_bucket, np.int64)
    ids_p[:t_real] = full_ids
    lab_p = np.full(t_bucket, IGNORE_INDEX, np.int64)
    lab_p[:t_real] = np.concatenate(label_parts)
    pos_p = np.zeros((3, t_bucket), np.int64)
    pos_p[:, :t_real] = np.concatenate(pos_parts, axis=1)
    seg = np.zeros(t_bucket, np.int32)
    seg[:t_real] = np.concatenate(seg_parts)
    image_pos = np.where(ids_p == cfg.image_token_id)[0][:n]
    image_pos_p = np.full(l_pad, t_bucket, np.int64)
    image_pos_p[:n] = image_pos

    return TrainBatchSample(
        num_merged=np.asarray(n, np.int32),
        k=np.asarray(max(1, int(n * budget)), np.int32),
        input_ids=ids_p,
        labels=lab_p,
        position_ids=pos_p,
        seg_ids=seg,
        image_positions=image_pos_p,
        **vision_fields(vb),
    )


def pack_text_samples(samples: List[dict], t_bucket: int) -> Optional[dict]:
    """First-fit packing plan over tokenized lengths
    (``visionselector_tpu.train.dataset.pack_text_samples``): each sample
    goes to the first group whose total ``len(sample["ids"])`` stays within
    ``t_bucket``, else opens a new one. Returns {"groups": [[index, ...],
    ...], "sizes": [total ids per group]}."""
    groups: List[List[int]] = []
    sizes: List[int] = []
    for i, s in enumerate(samples):
        n = len(s["ids"])
        for g in range(len(groups)):
            if sizes[g] + n <= t_bucket:
                groups[g].append(i)
                sizes[g] += n
                break
        else:
            groups.append([i])
            sizes.append(n)
    return {"groups": groups, "sizes": sizes}
