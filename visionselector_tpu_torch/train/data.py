"""Host-side training batch assembly (numpy).

Counterpart of ``visionselector_tpu.train.data``: ``TrainBatchSample``s
from (image, prompt ids, answer ids) triples: vision bucketing, label
masking (prompt positions IGNORE_INDEX, answer positions supervised),
M-RoPE position ids. Built on the port's own ``preprocess/``, so its kv
bounds are at the port's 64-row kernel tile, and by default on the
window-aligned layout that the engine uses (window layers then run the
block-diagonal kernel); ``align_windows=False`` gives the reference
training sample's classic layout.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from visionselector_tpu_torch.core.config import VLConfig
from visionselector_tpu_torch.preprocess.image import preprocess_image
from visionselector_tpu_torch.preprocess.indices import build_vision_batch
from visionselector_tpu_torch.preprocess.rope import (
    expand_vision_tokens,
    get_rope_index,
)
from visionselector_tpu_torch.train.loss import IGNORE_INDEX, TrainBatchSample


def vision_fields(vb) -> dict:
    """The ``TrainBatchSample`` fields a ``VisionBatch`` fills."""
    return dict(
        pixel_values=vb.pixel_values,
        rot_pos_ids=vb.rot_pos_ids,
        window_seg_ids=vb.window_seg_ids,
        full_seg_ids=vb.full_seg_ids,
        reverse_index=vb.reverse_index,
        window_kv_bounds=vb.window_kv_bounds,
        full_kv_bounds=vb.full_kv_bounds,
        window_diag=np.asarray(bool(vb.window_diag)),
        window_kv_iters=np.asarray(int(vb.window_kv_iters), np.int32),
        full_kv_iters=np.asarray(int(vb.full_kv_iters), np.int32),
    )


def build_train_sample(
    cfg: VLConfig,
    image,
    prompt_before: Sequence[int],
    prompt_after: Sequence[int],
    answer_ids: Sequence[int],
    budget: float,
    s_bucket: int,
    t_bucket: int,
    min_pixels: int = 56 * 56,
    max_pixels: int = 28 * 28 * 1280,
    align_windows: bool = True,
) -> TrainBatchSample:
    """One sample: [before][vision][after][answer]; loss on answer only."""
    pixels, grid = preprocess_image(
        image,
        min_pixels=min_pixels,
        max_pixels=max_pixels,
        patch_size=cfg.vision.patch_size,
        temporal_patch_size=cfg.vision.temporal_patch_size,
        merge_size=cfg.vision.spatial_merge_size,
    )
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

    prompt_ids = expand_vision_tokens(
        list(prompt_before), list(prompt_after), grid,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id,
    )
    ids = np.concatenate([prompt_ids, np.asarray(answer_ids, np.int64)])
    t_real = len(ids)
    if t_real > t_bucket:
        raise ValueError(f"sample of {t_real} tokens exceeds the text "
                         f"bucket {t_bucket}")

    labels = np.full(t_bucket, IGNORE_INDEX, np.int64)
    labels[len(prompt_ids): t_real] = answer_ids

    position_ids, _ = get_rope_index(
        ids, image_grid_thw=grid,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        tokens_per_second=cfg.vision.tokens_per_second,
        image_token_id=cfg.image_token_id,
        video_token_id=cfg.video_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
    )
    pos_padded = np.zeros((3, t_bucket), np.int64)
    pos_padded[:, :t_real] = position_ids

    ids_padded = np.full(t_bucket, 0, np.int64)
    ids_padded[:t_real] = ids
    seg = np.zeros(t_bucket, np.int32)
    seg[:t_real] = 1

    image_pos = np.where(ids_padded[:t_bucket] == cfg.image_token_id)[0][:n]
    image_pos_padded = np.full(l_pad, t_bucket, np.int64)
    image_pos_padded[:n] = image_pos

    return TrainBatchSample(
        num_merged=np.asarray(n, np.int32),
        k=np.asarray(max(1, int(n * budget)), np.int32),
        input_ids=ids_padded,
        labels=labels,
        position_ids=pos_padded,
        seg_ids=seg,
        image_positions=image_pos_padded,
        **vision_fields(vb),
    )


def stack_samples(samples: List[TrainBatchSample]) -> TrainBatchSample:
    """Stack per-sample NamedTuples into one batched NamedTuple."""
    cls = type(samples[0])
    return cls(
        *[np.stack([getattr(s, f) for s in samples]) for f in cls._fields]
    )
