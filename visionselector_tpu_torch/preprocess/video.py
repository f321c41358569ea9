"""Host-side video frame loading and sampling.

The port's copy of ``visionselector_tpu.preprocess.video`` (parity with
``qwen-vl-utils/src/qwen_vl_utils/vision_process.py``):

- ``smart_nframes`` (:149-186): frame-count selection from fps/nframes config,
  FRAME_FACTOR rounding, min/max bounds.
- frame-count capping by a total pixel budget (:393-447 semantics via
  ``video_pixel_budget``).
- inputs: a (T, H, W, C) array, an ``.npy`` file of one, a list of frame
  image files, a directory of frames, or a video file through decord, then
  PyAV (video decode stays a host concern).

Frame files are read with Pillow; where Pillow does not import, PNG frames
(8-bit RGB / RGBA) are read by ``preprocess.png.decode_png`` and any other
format raises.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from visionselector_tpu_torch.preprocess.image import (
    ceil_by_factor,
    floor_by_factor,
    preprocess_video_frames,
    round_by_factor,
)

FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768
VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = int(
    float(os.environ.get("VIDEO_MAX_PIXELS", 128000 * 28 * 28 * 0.9))
)


def smart_nframes(ele: dict, total_frames: int, video_fps: float) -> int:
    """Number of frames to sample (reference ``smart_nframes``)."""
    if "fps" in ele and "nframes" in ele:
        raise ValueError("Only accept either `fps` or `nframes`")
    if "nframes" in ele:
        nframes = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", FPS)
        min_frames = ceil_by_factor(ele.get("min_frames", FPS_MIN_FRAMES),
                                    FRAME_FACTOR)
        max_frames = floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
            FRAME_FACTOR)
        nframes = total_frames / video_fps * fps
        nframes = min(min(max(nframes, min_frames), max_frames), total_frames)
        nframes = floor_by_factor(nframes, FRAME_FACTOR)
    if not (FRAME_FACTOR <= nframes <= total_frames):
        raise ValueError(
            f"nframes should be in [{FRAME_FACTOR}, {total_frames}], got "
            f"{nframes}")
    return int(nframes)


def video_pixel_budget(nframes: int, total_pixels: int = VIDEO_TOTAL_PIXELS,
                       min_pixels: int = VIDEO_MIN_PIXELS,
                       max_pixels: int = VIDEO_MAX_PIXELS) -> int:
    """Per-frame max pixel budget so the whole clip stays under
    ``total_pixels`` (``vision_process.py:393-447`` semantics)."""
    per = int(total_pixels / max(nframes, 1) * FRAME_FACTOR)
    return max(min(max_pixels, per), min_pixels)


def _sample_indices(total: int, n: int) -> np.ndarray:
    return np.linspace(0, total - 1, n).round().astype(np.int64)


def read_frame(path: str) -> np.ndarray:
    """One frame file as [H, W, 3] uint8 RGB: Pillow where it imports, else
    ``decode_png`` (8-bit RGB / RGBA PNG only; ValueError otherwise)."""
    try:
        from PIL import Image  # noqa: PLC0415
    except ImportError:
        from visionselector_tpu_torch.preprocess.png import decode_png

        with open(path, "rb") as f:
            pixels = decode_png(f.read())
        if pixels is None:
            raise ValueError(
                f"{path}: only 8-bit non-interlaced RGB or RGBA PNG frames "
                f"are read without Pillow, and Pillow (PIL) is not "
                f"installed") from None
        return pixels
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_video_frames(
    video: str | Sequence[str] | np.ndarray,
    ele: Optional[dict] = None,
) -> Tuple[np.ndarray, float]:
    """Load + sample frames. Returns ((T, H, W, C) uint8, sampled_fps).

    Accepts: a list of frame image paths, a directory of frames (``.png``,
    ``.jpg``, ``.jpeg``, in name order), an (T, H, W, C) array, an ``.npy``
    file, or a video file (decord, then PyAV, where installed).
    """
    ele = ele or {}

    if isinstance(video, np.ndarray):
        total, fps = len(video), ele.get("video_fps", FPS)
        n = smart_nframes(ele, total, fps)
        return video[_sample_indices(total, n)], fps * n / total

    if isinstance(video, (list, tuple)) or (
        isinstance(video, str) and os.path.isdir(video)
    ):
        if isinstance(video, str):
            names = sorted(
                f for f in os.listdir(video)
                if f.lower().endswith((".png", ".jpg", ".jpeg"))
            )
            paths = [os.path.join(video, f) for f in names]
        else:
            paths = list(video)
        total = len(paths)
        fps = ele.get("video_fps", FPS)
        n = smart_nframes(ele, total, fps)
        idx = _sample_indices(total, n)
        frames = np.stack([read_frame(paths[i]) for i in idx])
        return frames, fps * n / total

    if isinstance(video, str) and video.endswith(".npy"):
        return load_video_frames(np.load(video), ele)

    # real video containers: decord then PyAV
    try:
        import decord  # noqa: PLC0415

        vr = decord.VideoReader(video)
        total, fps = len(vr), float(vr.get_avg_fps())
        n = smart_nframes(ele, total, fps)
        idx = _sample_indices(total, n)
        return vr.get_batch(idx.tolist()).asnumpy(), fps * n / total
    except ImportError:
        pass
    try:
        import av  # noqa: PLC0415

        container = av.open(video)
        stream = container.streams.video[0]
        fps = float(stream.average_rate)
        frames = [f.to_ndarray(format="rgb24")
                  for f in container.decode(stream)]
        total = len(frames)
        n = smart_nframes(ele, total, fps)
        idx = _sample_indices(total, n)
        return np.stack([frames[i] for i in idx]), fps * n / total
    except ImportError as e:
        raise RuntimeError(
            "no video backend available (decord/PyAV); provide a frame "
            "directory, frame list, or array instead"
        ) from e


def process_video(
    video,
    ele: Optional[dict] = None,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """video -> (pixel_values_videos, video_grid_thw, second_per_grid_t)."""
    ele = ele or {}
    frames, sampled_fps = load_video_frames(video, ele)
    budget = video_pixel_budget(len(frames))
    pixels, grid = preprocess_video_frames(
        frames,
        min_pixels=ele.get("min_pixels", VIDEO_MIN_PIXELS),
        max_pixels=ele.get("max_pixels", budget),
        patch_size=patch_size,
        temporal_patch_size=temporal_patch_size,
        merge_size=merge_size,
    )
    second_per_grid_t = temporal_patch_size / max(sampled_fps, 1e-6)
    return pixels, grid, second_per_grid_t
