"""The plain mirrors of the window-attention kernel (``diag_attn_fwd``,
``csrc/diag_attn_fwd.cu``), which runs only on the card: its persistent
schedule (``tiles.diag_items_plain``: every (batch, tile, head) item once,
for several grid sizes), its tile kinds
(``tiles.diag_tile_kinds_plain`` against numpy on the window-aligned
layout of the main path's image, on 16-patch windows with several
segments per tile, and on padding-only tiles), and ``diag_plain`` against
the JAX package's ``attention_diag`` (Pallas in interpret mode, as
``tests/test_torch_attention.py`` runs it) at every head dim with B = 2
and padding-only tiles; and the byte bound ``tools/diag_floor`` and
``chip_smoke.py`` hold the kernel to. Same numpy inputs from a seed go to both; fp32,
atol 1e-5 (fp32 sum-order differences, as ``test_torch_attention.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionselector_tpu.kernels import attention as jattn
from visionselector_tpu_torch.kernels import attention as tattn
from visionselector_tpu_torch.kernels import tiles as T
from visionselector_tpu_torch.preprocess.indices import build_vision_batch
from visionselector_tpu_torch.tools import diag_floor

ATOL = 1e-5
BLOCK = 64


def _kinds_np(seg):
    """[B, S] -> [B, S / 64] kinds by numpy: uniform where all 64 rows are
    one segment > 0, padding where all are 0, mixed otherwise."""
    t = np.asarray(seg).reshape(seg.shape[0], -1, BLOCK)
    uniform = (t == t[..., :1]).all(-1) & (t[..., 0] > 0)
    pad = (t == 0).all(-1)
    return np.where(pad, T.DIAG_PAD,
                    np.where(uniform, T.DIAG_UNIFORM, T.DIAG_MIXED))


def _windows16(s, b):
    """16-patch windows (several per tile, some cut short, every fifth
    missing), a padding-only tile every third tile; batch row r shifted by
    r tiles."""
    rows = []
    for r in range(b):
        seg = np.zeros(s, np.int32)
        for w in range(s // 16):
            tile = w // 4
            if (tile + r) % 3 == 2 or w % 5 == 4:
                continue
            seg[w * 16:w * 16 + 16 - (w % 3)] = w + 1
        rows.append(seg)
    return np.stack(rows)


@pytest.mark.parametrize("b, s, h, n_blocks", [
    (1, 6144, 16, 264), (1, 6144, 16, 132), (1, 6144, 16, 1),
    (2, 384, 6, 7), (2, 384, 6, 10_000), (3, 128, 5, 4)])
def test_diag_items_cover_every_item_once(b, s, h, n_blocks):
    blocks = T.diag_items_plain(b, s, h, n_blocks)
    n_items = b * (s // BLOCK) * h
    assert len(blocks) == min(n_blocks, n_items)
    walked = [item for blk in blocks for item in blk]
    want = {(i, t, j) for i in range(b) for t in range(s // BLOCK)
            for j in range(h)}
    assert len(walked) == len(want) and set(walked) == want
    # a block's items differ by the grid: at most one item more than any
    # other block's, so the walk is balanced
    counts = [len(blk) for blk in blocks]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("d, want", [(80, 54_460_416), (128, 87_121_920)])
def test_diag_needed_bytes_main_path_image(d, want):
    """The byte bound of ``tools/diag_floor`` (and of chip_smoke's K4
    cases) at the main path's image: q, k, v read for its 5,040 window
    rows only, out written and seg read for all 6,144 rows."""
    seg = diag_floor.window_seg("cpu")
    assert int((seg > 0).sum()) == 5040
    assert diag_floor.needed_bytes(seg, 16, d) == (
        3 * 5040 * 16 * d * 2 + 6144 * 16 * d * 2 + 6144 * 4) == want


def test_diag_needed_bytes_padding_and_batch():
    """Padding rows cost only their output write and seg read; batch rows
    add up."""
    seg = torch.as_tensor(_windows16(384, 2))
    valid = int((seg > 0).sum())
    assert diag_floor.needed_bytes(seg, 6, 24) == (
        (3 * valid + 2 * 384) * 6 * 24 * 2 + 2 * 384 * 4)
    pad = torch.zeros(1, 128, dtype=torch.int32)
    assert diag_floor.needed_bytes(pad, 6, 24) == 128 * 6 * 24 * 2 + 128 * 4


def test_diag_tile_kinds_main_path_image():
    """The main path's 1036x1456 image (grid 1x60x84) in the window-aligned
    layout of the 6,144 bucket: 70 whole-window tiles, 18 partial windows
    with padding rows, 8 padding-only tiles."""
    grid = np.asarray([[1, 60, 84]])
    n = int(np.prod(grid))
    vb = build_vision_batch(np.zeros((n, 1), np.float32), grid, pad_to=6144,
                            align_windows=True)
    assert vb.window_diag
    seg = np.asarray(vb.window_seg_ids)[None]
    kinds = T.diag_tile_kinds_plain(torch.as_tensor(seg))
    np.testing.assert_array_equal(kinds.numpy(), _kinds_np(seg))
    counts = np.bincount(kinds.numpy().ravel(), minlength=3)
    assert (counts[T.DIAG_UNIFORM], counts[T.DIAG_MIXED],
            counts[T.DIAG_PAD]) == (70, 18, 8)
    # the tile_seg rule: a uniform tile is one tile_seg_plain names
    ts = T.tile_seg_plain(torch.as_tensor(seg[0]))
    assert torch.equal(kinds[0] == T.DIAG_UNIFORM, ts >= 0)


@pytest.mark.parametrize("b, s", [(1, 256), (2, 768)])
def test_diag_tile_kinds_windows16_and_padding(b, s):
    seg = _windows16(s, b)
    kinds = T.diag_tile_kinds_plain(torch.as_tensor(seg)).numpy()
    np.testing.assert_array_equal(kinds, _kinds_np(seg))
    assert T.DIAG_PAD in kinds and T.DIAG_MIXED in kinds
    # every row padding; one segment filling every tile; rows past a
    # segment's end in its last tile
    for seg2, want in ((np.zeros((b, s), np.int32), T.DIAG_PAD),
                       (np.full((b, s), 7, np.int32), T.DIAG_UNIFORM)):
        got = T.diag_tile_kinds_plain(torch.as_tensor(seg2))
        assert (got == want).all()
    cut = np.full((1, s), 3, np.int32)
    cut[0, s - 5:] = 0
    got = T.diag_tile_kinds_plain(torch.as_tensor(cut))[0]
    assert (got[:-1] == T.DIAG_UNIFORM).all() and got[-1] == T.DIAG_MIXED
    with pytest.raises(ValueError):
        T.diag_tile_kinds_plain(torch.zeros(1, 100, dtype=torch.int32))


@pytest.mark.parametrize("d", [16, 24, 80, 128])
def test_diag_plain_matches_pallas_b2_every_head_dim(d):
    """B = 2, 3 heads, 16-patch windows and padding-only tiles: diag_plain
    equals the JAX attention_diag (block 64, interpret mode); padding rows
    exactly 0."""
    b, s, h = 2, 384, 3
    rng = np.random.RandomState(d)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    seg = _windows16(s, b)
    assert (_kinds_np(seg) == T.DIAG_PAD).any()
    want = jattn.attention_diag(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        block_q=BLOCK, interpret=True)
    got = tattn.diag_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                           torch.from_numpy(seg), block_q=BLOCK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert (got.numpy()[seg == 0] == 0).all()
