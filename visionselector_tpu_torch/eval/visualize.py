"""Selection visualization: score heatmaps and kept-token masks as PNGs.

Parity with the reference's visual adapter
(``lmms-eval/lmms_eval/models/qwen2_5_vl_with_token_compression_visual.py:418-663``):
renders (a) the importance-score heatmap over the merged-token grid blended
onto the image, (b) the binary kept/dropped mask. Pure numpy + PIL.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _colormap(x: np.ndarray) -> np.ndarray:
    """[0,1] -> RGB uint8 (simple blue->red diverging map)."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def score_grid(scores: np.ndarray, grid_thw, spatial_merge_size: int = 2) -> np.ndarray:
    """[N] merged-token scores -> [H_m, W_m] grid (single image, t=1)."""
    t, h, w = np.asarray(grid_thw).reshape(-1)[:3]
    hm, wm = int(h) // spatial_merge_size, int(w) // spatial_merge_size
    return np.asarray(scores[: hm * wm], np.float32).reshape(hm, wm)


def render_heatmap(
    image: np.ndarray,
    scores: np.ndarray,
    grid_thw,
    spatial_merge_size: int = 2,
    alpha: float = 0.5,
) -> np.ndarray:
    """Blend normalized scores over the (H, W, 3) uint8 image."""
    g = score_grid(scores, grid_thw, spatial_merge_size)
    lo, hi = g.min(), g.max()
    g = (g - lo) / (hi - lo + 1e-9)
    hm, wm = g.shape
    H, W = image.shape[:2]
    up = np.repeat(np.repeat(g, -(-H // hm), 0), -(-W // wm), 1)[:H, :W]
    heat = _colormap(up)
    out = (image.astype(np.float32) * (1 - alpha) + heat * alpha).astype(np.uint8)
    return out


def render_mask(
    image: np.ndarray,
    selected_indices: Sequence[int],
    grid_thw,
    spatial_merge_size: int = 2,
    dim: float = 0.75,
) -> np.ndarray:
    """Dim dropped-token regions; keep selected regions at full brightness."""
    t, h, w = np.asarray(grid_thw).reshape(-1)[:3]
    hm, wm = int(h) // spatial_merge_size, int(w) // spatial_merge_size
    keep = np.zeros(hm * wm, bool)
    keep[np.asarray(selected_indices, int)] = True
    keep = keep.reshape(hm, wm)
    H, W = image.shape[:2]
    up = np.repeat(np.repeat(keep, -(-H // hm), 0), -(-W // wm), 1)[:H, :W]
    out = image.astype(np.float32).copy()
    out[~up] *= 1 - dim
    return out.astype(np.uint8)


def save_png(array: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(array).save(path)


def visualize_selection(
    image: np.ndarray,
    scores: Optional[np.ndarray],
    selected_indices: Sequence[int],
    grid_thw,
    out_prefix: str,
    spatial_merge_size: int = 2,
) -> list:
    """Write <prefix>_heatmap.png (if scores given) and <prefix>_mask.png."""
    written = []
    if scores is not None:
        p = f"{out_prefix}_heatmap.png"
        save_png(render_heatmap(image, scores, grid_thw, spatial_merge_size), p)
        written.append(p)
    p = f"{out_prefix}_mask.png"
    save_png(render_mask(image, selected_indices, grid_thw, spatial_merge_size), p)
    written.append(p)
    return written
