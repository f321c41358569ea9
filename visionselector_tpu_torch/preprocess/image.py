"""Host-side image and video-frame preprocessing: smart_resize, normalize,
patchify.

The port's copy of ``visionselector_tpu.preprocess.image``. Copied rather
than imported so that a run of the port (``chip_smoke.py`` included) loads
no module of the JAX package; ``tests/test_torch_preprocess.py`` and
``tests/test_torch_native.py`` hold the copy equal to the reference.
Normalize + patchify run in one pass of the port's C library
(``visionselector_tpu_torch.native``) where it builds, else in numpy; the
two give the same arrays.

Semantics match the reference preprocessing pipeline:
- ``smart_resize``: factor-28 rounding within a pixel budget
  (``qwen-vl-utils/src/qwen_vl_utils/vision_process.py:60-86``).
- patch flattening layout: HF ``Qwen2VLImageProcessor._preprocess`` —
  ``[grid_t, tp, C, gh/m, m, ph, gw/m, m, pw] -> transpose(0,3,6,4,7,2,1,5,8)``
  so that rows are ordered by (t, merge-block row, merge-block col, intra-block).

These run on the CPU host (data-dependent shapes) and produce the
statically-shaped arrays the device path takes.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

# Default processor pixel bounds (HF Qwen2.5-VL preprocessor_config.json).
PROCESSOR_MIN_PIXELS = 56 * 56
PROCESSOR_MAX_PIXELS = 28 * 28 * 1280

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float64)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float64)


def round_by_factor(number: float, factor: int) -> int:
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    return math.floor(number / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
) -> Tuple[int, int]:
    """Rescale (height, width) so both are multiples of `factor` and the pixel
    count lies within [min_pixels, max_pixels], preserving aspect ratio."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"absolute aspect ratio must be smaller than {MAX_RATIO}, "
            f"got {max(height, width) / min(height, width)}"
        )
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, floor_by_factor(height / beta, factor))
        w_bar = max(factor, floor_by_factor(width / beta, factor))
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def _bilinear_resize(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Simple bilinear resize (H, W, C) float array — used when PIL is absent
    or the input is already a float array."""
    in_h, in_w = image.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return image
    # align_corners=False convention (matches PIL/torch antialias-off closely
    # enough for tests; real image paths go through PIL below).
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = image[y0][:, x0]
    b = image[y0][:, x1]
    c = image[y1][:, x0]
    d = image[y1][:, x1]
    return (a * (1 - wx) + b * wx) * (1 - wy) + (c * (1 - wx) + d * wx) * wy


def _resize_uint8_frames(frames: np.ndarray, out_h: int, out_w: int):
    """(T, H, W, 3) uint8 -> (T, out_h, out_w, 3) uint8 via PIL BICUBIC —
    the resample the HF processor applies to numpy inputs (it converts to
    PIL first; ``image_processing_qwen2_vl`` resample=BICUBIC) and the
    close match to the reference video path's antialiased bicubic
    (``vision_process.py`` torchvision resize). ~20x faster than the
    float64 numpy fallback. Returns None when PIL is unavailable."""
    try:
        from PIL import Image  # noqa: PLC0415
    except ImportError:
        return None
    out = np.empty((frames.shape[0], out_h, out_w, 3), np.uint8)
    for i, f in enumerate(frames):
        out[i] = np.asarray(
            Image.fromarray(f).resize((out_w, out_h), Image.BICUBIC)
        )
    return out


def resize_image(image, out_h: int, out_w: int) -> np.ndarray:
    """Resize to (out_h, out_w). Accepts a PIL image or (H, W, C) uint8/float
    numpy array; returns float64 (H, W, C) in [0, 255] range."""
    try:
        from PIL import Image  # noqa: PLC0415

        if isinstance(image, Image.Image):
            img = image.convert("RGB").resize((out_w, out_h), Image.BICUBIC)
            return np.asarray(img, dtype=np.float64)
    except ImportError:
        pass
    arr = np.asarray(image, dtype=np.float64)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return _bilinear_resize(arr, out_h, out_w)


def normalize_image(image: np.ndarray) -> np.ndarray:
    """Rescale [0,255] -> [0,1] then normalize with OpenAI-CLIP mean/std."""
    return (image / 255.0 - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD


def patchify(
    frames: np.ndarray,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Flatten normalized frames into patch rows.

    Args:
        frames: (T, C, H, W) normalized float array. For a single image T == 1
            (it is repeated to fill the temporal patch).
    Returns:
        (flatten_patches [grid_t*grid_h*grid_w, C*tp*ps*ps] float32,
         (grid_t, grid_h, grid_w))
    """
    patches = np.asarray(frames, dtype=np.float32)
    if patches.ndim == 3:  # (C, H, W) single image
        patches = patches[None]
    t, channel, height, width = patches.shape
    if t % temporal_patch_size != 0:
        repeats = np.repeat(
            patches[-1][None], temporal_patch_size - (t % temporal_patch_size), axis=0
        )
        patches = np.concatenate([patches, repeats], axis=0)
    grid_t = patches.shape[0] // temporal_patch_size
    grid_h, grid_w = height // patch_size, width // patch_size
    patches = patches.reshape(
        grid_t,
        temporal_patch_size,
        channel,
        grid_h // merge_size,
        merge_size,
        patch_size,
        grid_w // merge_size,
        merge_size,
        patch_size,
    )
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flatten_patches = patches.reshape(
        grid_t * grid_h * grid_w, channel * temporal_patch_size * patch_size**2
    )
    return flatten_patches, (grid_t, grid_h, grid_w)


def preprocess_image(
    image,
    min_pixels: int = PROCESSOR_MIN_PIXELS,
    max_pixels: int = PROCESSOR_MAX_PIXELS,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """PIL image / HWC array -> (pixel_values [S, patch_dim], grid_thw [1, 3])."""
    if isinstance(image, np.ndarray):
        height, width = image.shape[:2]
    else:  # PIL image
        width, height = image.size
    out_h, out_w = smart_resize(
        height,
        width,
        factor=patch_size * merge_size,
        min_pixels=min_pixels,
        max_pixels=max_pixels,
    )
    if (isinstance(image, np.ndarray) and image.ndim == 3
            and image.shape[2] == 3 and image.dtype == np.uint8):
        if (out_h, out_w) == (height, width):
            frame = image
        else:
            # PIL BICUBIC, as the HF processor resizes numpy inputs
            frame = _resize_uint8_frames(image[None], out_h, out_w)
            frame = (resize_image(image, out_h, out_w) if frame is None
                     else frame[0])
    else:
        frame = resize_image(image, out_h, out_w)
    flat = _native_patchify(np.asarray(frame)[None], patch_size,
                            temporal_patch_size, merge_size)
    if flat is not None:
        return flat, np.asarray([(1, out_h // patch_size,
                                  out_w // patch_size)], dtype=np.int64)
    normed = normalize_image(np.asarray(frame, np.float64)).transpose(2, 0, 1)
    flat, grid = patchify(
        normed[None],
        patch_size=patch_size,
        temporal_patch_size=temporal_patch_size,
        merge_size=merge_size,
    )
    return flat, np.asarray([grid], dtype=np.int64)


def _native_patchify(frames, patch_size, temporal_patch_size, merge_size):
    """The C library's normalize + patchify of (T, H, W, 3) uint8 or
    float64 frames, or None (no library, or input it does not take)."""
    from visionselector_tpu_torch.native import fused_normalize_patchify

    return fused_normalize_patchify(
        frames, patch_size, temporal_patch_size, merge_size,
        OPENAI_CLIP_MEAN, OPENAI_CLIP_STD)


def preprocess_video_frames(
    frames: np.ndarray,
    min_pixels: int = 128 * 28 * 28,
    max_pixels: int = 768 * 28 * 28,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """(T, H, W, C) uint8 / float frames -> (pixel_values_videos [t * h *
    w, patch_dim], video_grid_thw [1, 3]) with t = ceil(T / tp) (an odd
    frame count repeats its last frame). Frames are resized as the
    reference resizes them: uint8 frames per frame with PIL bicubic where
    PIL imports, otherwise (and for float frames) bilinear in float64."""
    frames = np.asarray(frames)
    t, height, width = frames.shape[:3]
    out_h, out_w = smart_resize(
        height,
        width,
        factor=patch_size * merge_size,
        min_pixels=min_pixels,
        max_pixels=max_pixels,
    )
    rgb_u8 = (frames.ndim == 4 and frames.shape[3] == 3
              and frames.dtype == np.uint8)
    if rgb_u8 and (out_h, out_w) == (height, width):
        resized = frames
    elif rgb_u8 and (r := _resize_uint8_frames(frames, out_h, out_w)) \
            is not None:
        resized = r
    else:
        frames = frames.astype(np.float64)
        resized = np.stack([_bilinear_resize(f, out_h, out_w)
                            for f in frames])
    flat = _native_patchify(resized, patch_size, temporal_patch_size,
                            merge_size)
    if flat is not None:
        grid = (-(-t // temporal_patch_size), out_h // patch_size,
                out_w // patch_size)
        return flat, np.asarray([grid], dtype=np.int64)
    normed = normalize_image(
        np.asarray(resized, np.float64)).transpose(0, 3, 1, 2)  # T, C, H, W
    flat, grid = patchify(
        normed,
        patch_size=patch_size,
        temporal_patch_size=temporal_patch_size,
        merge_size=merge_size,
    )
    return flat, np.asarray([grid], dtype=np.int64)
