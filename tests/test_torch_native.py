"""The port's native preprocessing (``visionselector_tpu_torch.native``:
its own copy of the fused normalize + patchify C source, built at first
use) against the numpy pipeline and against the JAX package's
``preprocess_image`` / ``preprocess_video_frames``: equal patch rows on
both paths, the build's name and place, and the numpy path taken where
no compiler builds it."""

import os

import numpy as np
import pytest
from PIL import Image

from visionselector_tpu.preprocess import image as jimage
from visionselector_tpu_torch import native
from visionselector_tpu_torch.preprocess import image as timage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(t, hw, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(t, *hw, 3) * 255).astype(np.uint8)


def _numpy_rows(frames):
    normed = timage.normalize_image(
        np.asarray(frames, np.float64)).transpose(0, 3, 1, 2)
    return timage.patchify(normed)[0]


@pytest.fixture
def numpy_path(monkeypatch):
    """The loader as on a machine whose compiler fails (restored after)."""
    monkeypatch.setattr(native, "_TRIED", True)
    monkeypatch.setattr(native, "_LIB", None)


def test_native_builds_into_its_build_dir():
    """A C compiler is on this host: the library builds (OpenMP or serial)
    into ``native/build/`` under a name carrying the source's hash, and the
    source is the port's own copy of the reference's C."""
    assert native.native_available(), native.BUILD_LOG
    so = native._so_path()
    assert os.path.isfile(so)
    assert os.path.dirname(so) == os.path.join(
        REPO, "visionselector_tpu_torch", "native", "build")
    with open(native._SRC) as f:
        ours = f.read()
    with open(os.path.join(REPO, "visionselector_tpu", "native",
                           "fused_preprocess.c")) as f:
        ref = f.read()
    body = ours[ours.index("#include"):]
    assert body == ref[ref.index("#include"):].replace(
        "see preprocess/image.py:116", "see preprocess/image.py:"
        "normalize_image")


@pytest.mark.parametrize("t, hw, dtype", [
    (1, (56, 84), np.uint8), (3, (56, 56), np.uint8), (4, (112, 84),
                                                        np.uint8),
    (2, (56, 84), np.float64)])
def test_fused_rows_equal_numpy(t, hw, dtype):
    frames = _frames(t, hw, seed=t).astype(dtype)
    got = native.fused_normalize_patchify(
        frames, 14, 2, 2, timage.OPENAI_CLIP_MEAN, timage.OPENAI_CLIP_STD)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, _numpy_rows(frames))


def test_fused_refuses_what_it_does_not_take():
    """Another dtype, a fourth channel or a side off the 28 grid: None (the
    caller takes numpy)."""
    mean, std = timage.OPENAI_CLIP_MEAN, timage.OPENAI_CLIP_STD
    for frames in (_frames(2, (56, 56)).astype(np.float32),
                   np.zeros((2, 56, 56, 4), np.uint8),
                   _frames(2, (56, 60))):
        assert native.fused_normalize_patchify(frames, 14, 2, 2, mean,
                                               std) is None


def _images():
    rng = np.random.RandomState(4)
    u8 = (rng.rand(70, 98, 3) * 255).astype(np.uint8)
    return {"u8_exact": u8[:56, :84], "u8_resize": u8,
            "float": u8.astype(np.float32), "gray": u8[..., 0],
            "pil": Image.fromarray(u8)}


@pytest.mark.parametrize("kind", ["u8_exact", "u8_resize", "float", "gray",
                                  "pil"])
def test_preprocess_image_both_paths_match_jax(kind, monkeypatch):
    image = _images()[kind]
    kw = dict(min_pixels=56 * 56, max_pixels=56 * 84)
    want, want_grid = jimage.preprocess_image(image, **kw)
    got, grid = timage.preprocess_image(image, **kw)
    np.testing.assert_array_equal(grid, want_grid)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    monkeypatch.setattr(native, "_TRIED", True)
    monkeypatch.setattr(native, "_LIB", None)
    slow, _ = timage.preprocess_image(image, **kw)
    np.testing.assert_array_equal(slow, got)


@pytest.mark.parametrize("t", [3, 4])
def test_video_frames_numpy_path_equals_native(t, numpy_path):
    frames = _frames(t, (60, 90), seed=t)
    kw = dict(min_pixels=1, max_pixels=10**9)
    assert not native.native_available()
    slow, grid = timage.preprocess_video_frames(frames, **kw)
    want, want_grid = jimage.preprocess_video_frames(frames, **kw)
    np.testing.assert_array_equal(grid, want_grid)
    np.testing.assert_allclose(slow, want, atol=1e-6, rtol=0)


def test_no_compiler_means_numpy(tmp_path, monkeypatch):
    """A compiler that does not run: no library, the reason in
    ``BUILD_LOG``, and ``preprocess_image`` still gives its rows."""
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    assert not native.native_available()
    assert "no-such-cc" in native.BUILD_LOG
    image = _frames(1, (56, 84))[0]
    got, _ = timage.preprocess_image(image)
    np.testing.assert_allclose(got, jimage.preprocess_image(image)[0],
                               atol=1e-6, rtol=0)
