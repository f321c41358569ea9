"""The port's warm-up CLI (``api/warmup.py``) against the JAX package's
(``visionselector_tpu/api/warmup.py``) on the CPU: the synthetic image of
each bucket bit-equal, the printed JSON lines with the reference's keys
and, per bucket, the patch count the reference's own preprocessing gives
that image (the JAX engine itself is not run: its generations compile
per shape and take minutes on the CPU); ``--device cuda`` without a card
fails as ``api.predict`` does."""

import json

import numpy as np
import pytest
import torch

from visionselector_tpu.api import warmup as jwarmup
from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.preprocess.image import preprocess_image
from visionselector_tpu_torch.api import warmup as twarmup


@pytest.mark.parametrize("patches, patch, merge", [
    (64, 14, 2), (128, 14, 2), (1024, 14, 2), (6144, 14, 2), (3, 14, 2),
    (500, 16, 2), (900, 14, 3)])
def test_synth_image_bit_equal(patches, patch, merge):
    want = jwarmup.synth_image_for_bucket(patches, patch, merge)
    got = twarmup.synth_image_for_bucket(patches, patch, merge)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _reference_patches(bucket):
    v = jax_tiny().vision
    img = jwarmup.synth_image_for_bucket(bucket, v.patch_size,
                                         v.spatial_merge_size)
    pixels, _ = preprocess_image(
        img, min_pixels=1, max_pixels=10**9, patch_size=v.patch_size,
        temporal_patch_size=v.temporal_patch_size,
        merge_size=v.spatial_merge_size)
    return int(pixels.shape[0])


@pytest.mark.parametrize("micro_batch, method", [(2, "selector"),
                                                 (4, "orig")])
def test_cli_lines_match_the_reference(capsys, micro_batch, method):
    """``main(["--device", "cpu", "--buckets", "64,128", "--micro-batch",
    N])``: one line per bucket with the reference's keys (bucket, patches,
    warmup_s) and patch count, then text_only, then decode_batch 2, 4, ...
    up to N; no kernel build line on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the decode loop's small ops
    try:
        assert twarmup.main(["--device", "cpu", "--buckets", "64,128",
                             "--micro-batch", str(micro_batch), "--method",
                             method, "--max-new-tokens", "2"]) == 0
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    buckets = [64, 128]
    batches = [2, 4][: micro_batch // 2]
    assert len(lines) == len(buckets) + 1 + len(batches)
    for bucket, line in zip(buckets, lines):
        assert set(line) == {"bucket", "patches", "warmup_s"}
        assert line["bucket"] == bucket
        assert line["patches"] == _reference_patches(bucket)
    assert lines[2].keys() == {"bucket", "warmup_s"}
    assert lines[2]["bucket"] == "text_only"
    assert [ln["decode_batch"] for ln in lines[3:]] == batches
    assert all(set(ln) == {"decode_batch", "warmup_s"} for ln in lines[3:])
    assert all(ln["warmup_s"] >= 0 for ln in lines)


def test_cuda_without_a_card_fails(monkeypatch):
    """``--device cuda`` (the default) on a host without a card raises
    SystemExit before any model loads."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        twarmup.main(["--buckets", "64"])
