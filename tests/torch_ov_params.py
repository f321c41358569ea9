"""Shared by the LLaVA-OneVision-1.5 parity tests (tests/test_torch_ov*.py):
llava_ov_tiny weights for both packages and the requests they run.

The weights are ``jax_ov_param_tree``'s with the decoder's matrices and
embedding scaled by LM_SCALE (norm scales and biases as they are), so that
greedy tokens vary, and the scorer at std 1, so that score gaps at the
top-k boundary exceed fp32 noise. ``four_layers`` gives the decoder the
depth an LLM-side strategy's capture layer needs (FastV at target 2)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_port_params import jax_ov_param_tree

from visionselector_tpu.core.config import llava_ov_tiny as jax_ov_tiny
from visionselector_tpu_torch.core.config import llava_ov_tiny
from visionselector_tpu_torch.models.llava_ov15.weights import (
    ov_from_jax_params,
)
from visionselector_tpu_torch.preprocess.image import (
    preprocess_image,
    preprocess_video_frames,
)
from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

LM_SCALE = 8.0
EOS = (-1,)  # run every request to its budget
TP = 1  # RICE's temporal patch


def four_layers(cfg):
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=4))


def ov_tree(layers: int = 2, seed: int = 0, cfg=None) -> dict:
    """The weight tree (numpy leaves) of llava_ov_tiny at ``layers``
    decoder layers, or of the JAX config ``cfg``."""
    if cfg is None:
        cfg = jax_ov_tiny() if layers == 2 else four_layers(jax_ov_tiny())

    def scale(path, x):
        name = jax.tree_util.keystr(path)
        if name.startswith("['lm']") and not name.endswith(
                ("_scale']", "_bias']")):
            return x * LM_SCALE
        return x

    return jax.tree_util.tree_map_with_path(
        scale, jax_ov_param_tree(cfg, seed, scorer_std=1.0))


def configs(layers: int = 2):
    """(JAX config, port config) at ``layers`` decoder layers."""
    if layers == 2:
        return jax_ov_tiny(), llava_ov_tiny()
    return four_layers(jax_ov_tiny()), four_layers(llava_ov_tiny())


def port_params(tree, layers: int = 2):
    return ov_from_jax_params(tree, configs(layers)[1], "cpu")


def image(h, w, seed):
    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    return preprocess_image(img, min_pixels=1, max_pixels=10**9,
                            temporal_patch_size=TP)


def video(frames=4, hw=56, seed=7):
    """A ``frames``-frame clip: (pixel rows, grid (frames, h, w))."""
    x = (np.random.RandomState(seed).rand(frames, hw, hw, 3) * 255
         ).astype(np.uint8)
    return preprocess_video_frames(x, min_pixels=1, max_pixels=10**9,
                                   temporal_patch_size=TP)


def requests() -> dict:
    """The parity requests by name: generate keywords."""
    cfg = llava_ov_tiny()
    px, grid = image(112, 140, 0)
    p1, g1 = image(56, 56, 21)
    p2, g2 = image(56, 84, 22)
    two = np.concatenate([g1, g2])
    vpx, vgrid = video()
    return {
        "image": dict(input_ids=expand_vision_tokens([100, 200],
                                                     [300, 400, 500], grid),
                      pixel_values=px, grid_thw=grid),
        "two images": dict(
            input_ids=expand_vision_tokens([100, 200], [300, 410], two),
            pixel_values=np.concatenate([p1, p2]), grid_thw=two),
        "video": dict(
            input_ids=expand_vision_tokens(
                [100, 200], [300, 420], vgrid,
                image_token_id=cfg.video_token_id),
            pixel_values_videos=vpx, video_grid_thw=vgrid,
            second_per_grid_ts=np.array([1.0])),
        "text": dict(input_ids=np.arange(40, 75, dtype=np.int64)),
    }


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs (the tiny decode loop's
    small ops stall on oversubscribed threads in the parallel Tier-1
    run). Autouse in every module that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
