"""The port's video preprocessing (``preprocess.video`` and
``preprocess.image.preprocess_video_frames``) against the JAX package's:
frame-count selection, the pixel budget, frame loading from an array, an
``.npy`` file, a PNG directory and a list of files (with and without
Pillow), patch rows within 1e-6 (odd frame counts included), and the
vision batch of a real clip's grid at the 16,384 bucket: the layout the
capped flash call (the reference's streamed kernel) runs, checked without
any attention."""

import sys

import numpy as np
import pytest
from PIL import Image

from visionselector_tpu.preprocess import image as jimage
from visionselector_tpu.preprocess import indices as jindices
from visionselector_tpu.preprocess import video as jvideo
from visionselector_tpu_torch.preprocess import image as timage
from visionselector_tpu_torch.preprocess import indices as tindices
from visionselector_tpu_torch.preprocess import video as tvideo


def _frames(t, hw=(56, 84), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(t, *hw, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("ele, total, fps", [
    ({}, 16, 2.0), ({}, 300, 30.0), ({"fps": 1.0}, 40, 4.0),
    ({"nframes": 7}, 20, 2.0), ({"min_frames": 6, "max_frames": 10}, 90,
                                 30.0)])
def test_smart_nframes_and_budget_match_jax(ele, total, fps):
    n = tvideo.smart_nframes(ele, total, fps)
    assert n == jvideo.smart_nframes(ele, total, fps)
    assert tvideo.video_pixel_budget(n) == jvideo.video_pixel_budget(n)
    for k in ("FRAME_FACTOR", "FPS", "FPS_MIN_FRAMES", "FPS_MAX_FRAMES",
              "VIDEO_MIN_PIXELS", "VIDEO_MAX_PIXELS", "VIDEO_TOTAL_PIXELS"):
        assert getattr(tvideo, k) == getattr(jvideo, k), k


def test_smart_nframes_refusals():
    with pytest.raises(ValueError, match="either"):
        tvideo.smart_nframes({"fps": 1.0, "nframes": 4}, 10, 2.0)
    with pytest.raises(ValueError, match="nframes should be"):
        tvideo.smart_nframes({"nframes": 12}, 10, 2.0)


def _sources(tmp_path, clip):
    """The clip as an array, an .npy file, a PNG directory (names sort in
    frame order) and a list of frame files."""
    np.save(tmp_path / "clip.npy", clip)
    d = tmp_path / "frames"
    d.mkdir()
    paths = []
    for i, fr in enumerate(clip):
        paths.append(str(d / f"f{i:03d}.png"))
        Image.fromarray(fr).save(paths[-1])
    return {"array": clip, "npy": str(tmp_path / "clip.npy"),
            "dir": str(d), "list": paths}


@pytest.mark.parametrize("kind", ["array", "npy", "dir", "list"])
def test_load_video_frames_matches_jax(tmp_path, kind):
    clip = _frames(12)
    src = _sources(tmp_path, clip)[kind]
    for ele in ({}, {"nframes": 6}):
        got, fps = tvideo.load_video_frames(src, ele)
        want, want_fps = jvideo.load_video_frames(src, ele)
        np.testing.assert_array_equal(got, want)
        assert fps == want_fps
    np.testing.assert_array_equal(tvideo.load_video_frames(src)[0], clip)


def test_frames_without_pillow(tmp_path, monkeypatch):
    """With no Pillow, PNG frames are read by ``decode_png`` (equal
    frames); a JPEG frame raises."""
    clip = _frames(4)
    src = _sources(tmp_path, clip)
    Image.fromarray(clip[0]).save(tmp_path / "f.jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    got, _ = tvideo.load_video_frames(src["dir"])
    np.testing.assert_array_equal(got, clip)
    with pytest.raises(ValueError, match="Pillow"):
        tvideo.read_frame(str(tmp_path / "f.jpg"))


def test_video_container_needs_a_backend(tmp_path):
    path = tmp_path / "clip.mp4"
    path.write_bytes(b"\0" * 16)
    with pytest.raises(RuntimeError, match="no video backend"):
        tvideo.load_video_frames(str(path))


@pytest.mark.parametrize("t, hw, dtype", [
    (4, (56, 84), np.uint8), (5, (56, 84), np.uint8), (3, (60, 90), np.uint8),
    (1, (56, 56), np.uint8), (5, (60, 90), np.float32)])
def test_preprocess_video_frames_matches_jax(t, hw, dtype):
    """Patch rows within 1e-6 and equal grids, t = ceil(T / 2); odd frame
    counts repeat the last frame; frames off the 28 grid are resized
    (Pillow bicubic for uint8, bilinear float64 otherwise)."""
    frames = _frames(t, hw, seed=t).astype(dtype)
    for kw in ({"min_pixels": 1, "max_pixels": 10**9},
               {"min_pixels": 56 * 56, "max_pixels": 56 * 84}):
        got, grid = timage.preprocess_video_frames(frames, **kw)
        want, want_grid = jimage.preprocess_video_frames(frames, **kw)
        np.testing.assert_array_equal(grid, want_grid)
        assert grid[0, 0] == -(-t // 2)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_process_video_matches_jax(tmp_path):
    clip = _frames(9, (60, 90), seed=5)
    np.save(tmp_path / "c.npy", clip)
    for ele in ({}, {"nframes": 4, "max_pixels": 56 * 56}):
        got = tvideo.process_video(str(tmp_path / "c.npy"), ele)
        want = jvideo.process_video(str(tmp_path / "c.npy"), ele)
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_clip_vision_batch_at_the_16384_bucket():
    """A 16-frame 360x640 clip's real grid (8, 26, 46): 9,568 patches,
    12,288 window-aligned rows, so the 16,384 bucket, where the flash
    call's kv_iters cap turns on. The port's vision batch equals the JAX
    package's in its segment ids, orders and rotary ids; its kv bounds are
    the reference's ``segment_block_bounds`` at the port's 64-row tile
    (the reference builds them at its 512-row Pallas block, which the port
    does not copy) and its cap the reference's ``_stable_kv_iters`` of
    those (32 tiles). An 8,192-bucket layout has no cap."""
    from visionselector_tpu.kernels.attention import segment_block_bounds

    grid = np.asarray([[8, 26, 46]])
    n = int(np.prod(grid))
    pixels = np.zeros((n, 1176), np.float32)
    assert tindices.aligned_window_len(grid) == 12288
    assert tindices.pick_bucket(12288, [8192, 16384]) == 16384
    got = tindices.build_vision_batch(pixels, grid, pad_to=16384,
                                      align_windows=True)
    want = jindices.build_vision_batch(pixels, grid, pad_to=16384,
                                       align_windows=True)
    assert (got.num_patches, got.num_merged) == (9568, 2392)
    assert got.window_diag == want.window_diag
    for f in ("window_seg_ids", "full_seg_ids", "window_index",
              "reverse_index", "rot_pos_ids", "pixel_values"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for seg, bounds, iters, name in (
            (got.full_seg_ids, got.full_kv_bounds, got.full_kv_iters, "full"),
            (got.window_seg_ids, got.window_kv_bounds, got.window_kv_iters,
             "window")):
        ref = segment_block_bounds(seg, 64, 64)
        np.testing.assert_array_equal(bounds, ref, err_msg=name)
        assert iters == jindices._stable_kv_iters(
            int((ref[:, 1] - ref[:, 0]).max()), 16384 // 64, 16384), name
    assert got.full_kv_iters == 32
    # per-frame segments: 8 frames (t = 8) of 1,196 patches each
    seg = got.full_seg_ids
    assert sorted(np.unique(seg[seg > 0])) == list(range(1, 9))
    assert all((seg == i).sum() == 1196 for i in range(1, 9))
    small = tindices.build_vision_batch(
        np.zeros((4 * 26 * 46, 1176), np.float32), np.asarray([[4, 26, 46]]),
        pad_to=8192, align_windows=True)
    assert small.full_kv_iters == 0
