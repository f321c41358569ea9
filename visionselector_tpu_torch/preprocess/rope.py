"""Host-side 3D M-RoPE position-id construction (numpy).

The port's copy of ``visionselector_tpu.preprocess.rope``: a numpy
re-implementation of the reference ``get_rope_index``
(``qwen-evaluation/qwen25vl/modeling_qwen2_5_vl.py:1550-1725``, twin
``qwen-vl-finetune/qwenvl/data/rope2d.py:get_rope_index_25``).
Copied rather than imported so that a run of the port (``chip_smoke.py``
included) loads no module of the JAX package;
``tests/test_torch_preprocess.py`` holds the copy equal to the reference.

- text tokens: all three axes share a scalar position that increments by 1,
- vision blocks: temporal axis steps by ``second_per_grid_t * tokens_per_second``
  per temporal patch; height/width axes enumerate the merged grid,
- each segment starts at (max position so far) + 1,
- ``rope_delta = max(position) + 1 - len(sequence)`` feeds decode positions.

Computed once per sample on the host (data-dependent shape logic), then the
device gathers it through the compaction (selected) indices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def get_rope_index(
    input_ids: np.ndarray,
    image_grid_thw: Optional[np.ndarray] = None,
    video_grid_thw: Optional[np.ndarray] = None,
    second_per_grid_ts: Optional[np.ndarray] = None,
    spatial_merge_size: int = 2,
    tokens_per_second: int = 2,
    image_token_id: int = 151655,
    video_token_id: int = 151656,
    vision_start_token_id: int = 151652,
) -> Tuple[np.ndarray, int]:
    """Build [3, T] M-RoPE position ids for one (unpadded) sequence.

    Returns (position_ids [3, T] int64, rope_delta int).
    """
    ids = np.asarray(input_ids).reshape(-1)
    t_len = len(ids)

    has_vision = (
        (image_grid_thw is not None and len(image_grid_thw) > 0)
        or (video_grid_thw is not None and len(video_grid_thw) > 0)
    )
    if not has_vision:
        pos = np.arange(t_len)
        return np.tile(pos, (3, 1)).astype(np.int64), int(pos.max(initial=-1) + 1 - t_len)

    vision_starts = np.where(ids == vision_start_token_id)[0]
    vision_kinds = ids[vision_starts + 1] if len(vision_starts) else np.array([])

    pos_list = []
    st = 0
    image_index = 0
    video_index = 0
    input_tokens = ids.tolist()

    num_blocks = len(vision_starts)
    for _ in range(num_blocks):
        # next image/video token occurrence from st
        ed_image = (
            input_tokens.index(image_token_id, st)
            if image_token_id in input_tokens[st:]
            else t_len + 1
        )
        ed_video = (
            input_tokens.index(video_token_id, st)
            if video_token_id in input_tokens[st:]
            else t_len + 1
        )
        if ed_image < ed_video:
            t, h, w = np.asarray(image_grid_thw)[image_index]
            second_per_grid_t = 0.0
            image_index += 1
            ed = ed_image
        else:
            t, h, w = np.asarray(video_grid_thw)[video_index]
            if second_per_grid_ts is not None:
                second_per_grid_t = float(second_per_grid_ts[video_index])
            else:
                second_per_grid_t = 1.0
            video_index += 1
            ed = ed_video

        llm_t = int(t)
        llm_h = int(h) // spatial_merge_size
        llm_w = int(w) // spatial_merge_size
        text_len = ed - st

        st_idx = pos_list[-1].max() + 1 if pos_list else 0
        pos_list.append(np.tile(np.arange(text_len), (3, 1)) + st_idx)

        t_index = (
            (np.arange(llm_t)[:, None] * second_per_grid_t * tokens_per_second)
            .astype(np.int64)
            .repeat(llm_h * llm_w, axis=1)
            .reshape(-1)
        )
        h_index = np.tile(
            np.arange(llm_h)[None, :, None], (llm_t, 1, llm_w)
        ).reshape(-1)
        w_index = np.tile(
            np.arange(llm_w)[None, None, :], (llm_t, llm_h, 1)
        ).reshape(-1)
        pos_list.append(np.stack([t_index, h_index, w_index]) + text_len + st_idx)
        st = ed + llm_t * llm_h * llm_w

    if st < t_len:
        st_idx = pos_list[-1].max() + 1 if pos_list else 0
        pos_list.append(np.tile(np.arange(t_len - st), (3, 1)) + st_idx)

    positions = np.concatenate(pos_list, axis=1).astype(np.int64)
    assert positions.shape == (3, t_len), (positions.shape, t_len)
    rope_delta = int(positions.max() + 1 - t_len)
    return positions, rope_delta


def expand_vision_tokens(
    prompt_ids_before: list,
    prompt_ids_after: list,
    grid_thw: np.ndarray,
    spatial_merge_size: int = 2,
    image_token_id: int = 151655,
    vision_start_token_id: int = 151652,
    vision_end_token_id: int = 151653,
) -> np.ndarray:
    """Build input ids: before + <vision_start> + image_pad*N + <vision_end> + after.

    N = prod(grid) / merge^2 per image (the processor's ``<|image_pad|>``
    expansion, ``qwen25vl/processing_qwen2_5_vl.py:48-219``).
    """
    ids = list(prompt_ids_before)
    for t, h, w in np.asarray(grid_thw):
        n = int(t * h * w) // (spatial_merge_size**2)
        ids += [vision_start_token_id] + [image_token_id] * n + [vision_end_token_id]
    ids += list(prompt_ids_after)
    return np.asarray(ids, dtype=np.int64)


def expand_vision_tokens_at_slots(
    ids: list,
    slots: list,
    grid_thw: np.ndarray,
    spatial_merge_size: int = 2,
    image_token_id: int = 151655,
    vision_start_token_id: int = 151652,
    vision_end_token_id: int = 151653,
) -> np.ndarray:
    """Splice one ``<vision_start> image_pad*N <vision_end>`` run per grid
    row into ``ids``, image ``i``'s at offset ``slots[i]`` (the
    interleaved multi-image form of :func:`expand_vision_tokens`; the
    processor expands each ``<|image_pad|>`` placeholder in place). Raises
    ValueError when the slots do not match the grid rows one for one or do
    not ascend (the reference asserts both)."""
    grid_thw = np.asarray(grid_thw)
    if len(slots) != len(grid_thw):
        raise ValueError(f"{len(slots)} slots for {len(grid_thw)} grid rows")
    if list(slots) != sorted(slots):
        raise ValueError(f"vision slots must ascend, got {list(slots)}")
    out, prev = [], 0
    for sl, (t, h, w) in zip(slots, grid_thw):
        n = int(t * h * w) // (spatial_merge_size**2)
        out += list(ids[prev:sl])
        out += ([vision_start_token_id] + [image_token_id] * n
                + [vision_end_token_id])
        prev = sl
    out += list(ids[prev:])
    return np.asarray(out, dtype=np.int64)
