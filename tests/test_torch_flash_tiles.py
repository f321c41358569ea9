"""The plain versions of the flash route's image prologue and main loop
(``kernels/tiles.py``): ``flash_images_plain``'s tile images unpack to q, k
and v bit for bit (the ViT's strided ``unbind`` views, K3's slab views at
dp = 128, GQA, B = 2, Sq != Sk), its tile segment ids equal numpy, and
attention from the images (``images_attention_plain``) equals the JAX
package's Pallas kernels in interpret mode, as
``tests/test_torch_attention.py`` and ``tests/test_torch_ablate.py`` run
them, causal GQA included (kv expanded for the JAX side as its decoder
does). ``flash_steps_plain``, the main loop's schedule, is held to the
masks of ``flash_plain``. Same numpy inputs from a seed go to both; fp32.

Tolerances: atol 1e-5 against the flash kernels (fp32 sum-order
differences between a dense softmax and the kernels' online softmax); the
ablation variants as ``test_torch_ablate.py`` (atol 3e-5 / rtol 1e-4 with
the exp, 1e-4 / 1e-4 without).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ablate import _jax_variant, jbench  # noqa: F401
from test_torch_ablate import _inputs as _ablate_inputs
from test_torch_cuda import _tile_seg_np
from test_torch_fused import _layouts

from visionselector_tpu.kernels import attention as jattn
from visionselector_tpu_torch.kernels import attention as tattn
from visionselector_tpu_torch.kernels import tiles as T

HEAD_DIMS = [16, 24, 64, 80, 128]
ATOL = 1e-5
BLOCK = 64


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unpacked(img, s, d, transpose=False):
    return torch.stack([T.unpack_tiles(x, s, d, transpose=transpose)
                        for x in img])


def _check_images(q, k, v, q_seg, kv_seg):
    """The images unpack to q, k, v bit for bit, with zero pads and rows."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    q_img, k_img, vt_img, q_ts, kv_ts = T.flash_images_plain(q, k, v, q_seg,
                                                             kv_seg)
    dp, nq, nk = T.padded_head_dim(d), -(-sq // BLOCK), -(-sk // BLOCK)
    assert q_img.shape == (b, h, nq, BLOCK * dp)
    assert k_img.shape == vt_img.shape == (b, h_kv, nk, BLOCK * dp)
    assert q_ts.shape == (b, nq) and kv_ts.shape == (b, nk)
    assert torch.equal(_unpacked(q_img, sq, d), q)
    assert torch.equal(_unpacked(k_img, sk, d), k)
    assert torch.equal(_unpacked(vt_img, sk, d, transpose=True), v)
    # every element of the images is one of q's (k's, v's) or a zero pad
    for img, x in ((q_img, q), (k_img, k), (vt_img, v)):
        assert int((img != 0).sum()) == int((x != 0).sum())
    return q_ts, kv_ts


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_images_of_vit_unbind_views(d):
    """q, k, v as the ViT splits them: strided views of one qkv slab."""
    s, h = 333, 3
    rng = np.random.RandomState(d)
    qkv = _t(rng.randn(s, 3 * h * d).astype(np.float32))
    q, k, v = (x[None] for x in qkv.view(s, 3, h, d).unbind(1))
    assert not q.is_contiguous()
    seg = _t(_layouts(s)["full"][None])
    q_ts, kv_ts = _check_images(q, k, v, seg, seg)
    assert torch.equal(q_ts, kv_ts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_images_of_packed_slab_views_keep_the_pad_columns(dtype):
    """K3: [1, S, H * 128] column slices of one slab; the images are built
    at dp = 128 from the slab as it is, pad-column noise included."""
    s, h, h_kv, dp = 200, 4, 2, 128
    rng = np.random.RandomState(1)
    slab = _t(rng.randn(1, s, (h + 2 * h_kv) * dp).astype(np.float32)).to(
        dtype)
    q, k, v = (tattn._heads(x, n, dp, name) for x, n, name in zip(
        slab.split([h * dp, h_kv * dp, h_kv * dp], -1), (h, h_kv, h_kv),
        "qkv"))
    seg = _t(_layouts(s)["window"][None])
    _check_images(q, k, v, seg, seg)


def test_images_of_gqa_batch_with_unequal_lengths():
    """GQA 4/2, B = 2, Sq = 200 against Sk = 333, each batch row its own
    segments."""
    b, sq, sk, h, h_kv, d = 2, 200, 333, 4, 2, 80
    rng = np.random.RandomState(2)
    q = _t(rng.randn(b, sq, h, d).astype(np.float32))
    k, v = (_t(rng.randn(b, sk, h_kv, d).astype(np.float32))
            for _ in range(2))
    q_seg = np.stack([_layouts(sq)["full"], _layouts(sq)["video"]])
    kv_seg = np.stack([_layouts(sk)["window"], _layouts(sk)["full"]])
    q_ts, kv_ts = _check_images(q, k, v, _t(q_seg), _t(kv_seg))
    for i in range(b):
        np.testing.assert_array_equal(q_ts[i].numpy(), _tile_seg_np(q_seg[i]))
        np.testing.assert_array_equal(kv_ts[i].numpy(),
                                      _tile_seg_np(kv_seg[i]))


@pytest.mark.parametrize("s", [256, 333])
@pytest.mark.parametrize("kind", ["window", "full", "video"])
def test_images_tile_seg_matches_numpy(kind, s):
    seg = _layouts(s)[kind]
    x = torch.zeros(1, s, 1, 16)
    _, _, _, q_ts, kv_ts = T.flash_images_plain(x, x, x, _t(seg[None]),
                                                _t(seg[None]))
    assert q_ts.dtype == torch.int32
    np.testing.assert_array_equal(q_ts[0].numpy(), _tile_seg_np(seg))
    assert torch.equal(q_ts, kv_ts)


def _from_images(q, k, v, seg, **kw):
    imgs = T.flash_images_plain(_t(q), _t(k), _t(v), _t(seg), _t(seg))
    return T.images_attention_plain(*imgs[:3], _t(seg), _t(seg), q.shape[-1],
                                    **kw).numpy()


def _qkv(seed, s, h, h_kv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, s, h, d).astype(np.float32),
            rng.randn(1, s, h_kv, d).astype(np.float32),
            rng.randn(1, s, h_kv, d).astype(np.float32))


def _oracle(q, k, v, seg):
    """Segment-masked attention in float64 numpy (GQA by repetition)."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, rep, 2), np.repeat(v, rep, 2)
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    mask = (seg[:, None, :, None] == seg[:, None, None, :]) & (
        seg[:, None, None, :] > 0)
    logits = np.where(mask, logits, -np.inf)
    m = logits.max(-1, keepdims=True)
    p = np.where(mask, np.exp(logits - np.where(np.isfinite(m), m, 0.0)), 0)
    l = p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bkhd->bqhd", p / np.where(l == 0, 1, l), v)
    return out


def _host_context() -> str:
    """The host facts a CPU numerics difference could follow."""
    import os

    import jax

    try:
        with open("/proc/cpuinfo") as f:
            flags = set(next((ln for ln in f if ln.startswith("flags")),
                             "").split())
    except OSError:
        flags = set()
    cpu = sorted(x for x in flags if x in ("avx512f", "avx512_bf16")
                 or x.startswith("amx"))
    return (f"cpu flags {cpu}, os.cpu_count {os.cpu_count()}, torch threads "
            f"{torch.get_num_threads()} / interop "
            f"{torch.get_num_interop_threads()}, XLA_FLAGS "
            f"{os.environ.get('XLA_FLAGS', '')!r}, jax {jax.__version__} "
            f"devices {len(jax.devices())}")


def _assert_close_with_context(got, want, q, k, v, seg, atol):
    """``assert_allclose(got, want, atol)``; on failure the message says
    where and by how much, each side's distance from a float64 oracle, and
    the host's numerics context."""
    err = np.abs(got - want)
    if err.max() <= atol:
        return
    b, row, h, col = np.unravel_index(err.argmax(), err.shape)
    oracle = _oracle(q, k, v, seg)
    raise AssertionError(
        f"max |port - jax| {err.max()!r} > atol {atol}: {(err > atol).sum()} "
        f"of {err.size} elements; worst at row {row} head {h} column {col} "
        f"(segment {seg[b, row]}, q tile {row // BLOCK}; rows off "
        f"{sorted(set(np.nonzero(err > atol)[1].tolist()))[:16]}); "
        f"max |port - float64| {np.abs(got - oracle).max()!r}, max |jax - "
        f"float64| {np.abs(want - oracle).max()!r}; {_host_context()}")


@pytest.mark.parametrize("kind", ["full", "window", "video"])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_images_attention_matches_pallas_with_bounds(d, kind):
    """K1: the ViT's full-attention layers, kv-tile bounds."""
    s = 256
    q, k, v = _qkv(d, s, 2, 2, d)
    seg = _layouts(s)[kind][None]
    bounds = jattn.segment_block_bounds(seg[0], BLOCK, BLOCK)
    want = jattn._flash_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(seg), False, d**-0.5, BLOCK, BLOCK,
        kv_bounds=jnp.asarray(bounds), interpret=True)
    got = _from_images(q, k, v, seg, kv_bounds=bounds)
    _assert_close_with_context(got, np.asarray(want), q, k, v, seg, ATOL)
    assert (got[0, seg[0] == 0] == 0).all()


def test_images_attention_gqa_matches_expanded_pallas():
    """Query head h reads kv head h // 4 of the k and v^T images."""
    s, d, n_rep = 192, 64, 4
    q, k, v = _qkv(7, s, 2 * n_rep, 2, d)
    seg = (np.arange(s) < 150).astype(np.int32)[None]
    want = jattn._flash_pallas(
        jnp.asarray(q), jnp.asarray(np.repeat(k, n_rep, 2)),
        jnp.asarray(np.repeat(v, n_rep, 2)), jnp.asarray(seg),
        jnp.asarray(seg), False, d**-0.5, BLOCK, BLOCK, interpret=True)
    got = _from_images(q, k, v, seg)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    assert (got[0, 150:] == 0).all()


@pytest.mark.parametrize("kv_iters", [None, 2, 1])
def test_images_attention_matches_streamed_kv_iters(kv_iters):
    """K2: a q tile sees kv tiles [lo, min(hi, lo + kv_iters))."""
    s, d = 256, 16
    q, k, v = _qkv(9, s, 2, 2, d)
    seg = np.repeat(np.arange(1, 3), s // 2).astype(np.int32)[None]
    bounds = jattn.segment_block_bounds(seg[0], BLOCK, BLOCK)
    want = jattn._flash_pallas_streamed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(seg), False, d**-0.5, BLOCK, BLOCK, jnp.asarray(bounds),
        interpret=True, kv_iters=kv_iters)
    got = _from_images(q, k, v, seg, kv_bounds=bounds, kv_iters=kv_iters)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("real_d", [80, 128])
def test_images_attention_matches_pallas_packed(real_d):
    """K3: heads of real_d zero-padded to dp = 128, the real scale; the
    images hold all 128 columns and the output's pad columns are 0."""
    s, h, dp = 256, 2, 128
    rng = np.random.RandomState(real_d)
    seg = np.concatenate([np.repeat(np.arange(1, 4), 70),
                          np.zeros(16, np.int32), np.full(30, 4)])
    seg = seg.astype(np.int32)[None]

    def heads():
        x = np.zeros((1, s, h, dp), np.float32)
        x[..., :real_d] = rng.randn(1, s, h, real_d)
        return x

    q, k, v = heads(), heads(), heads()
    bounds = jattn.segment_block_bounds(seg[0], BLOCK, BLOCK)
    want = jattn._flash_pallas_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        jnp.asarray(seg), False, real_d**-0.5, block_q=BLOCK, block_k=BLOCK,
        kv_bounds=jnp.asarray(bounds), interpret=True)
    got = _from_images(q, k, v, seg, scale=real_d**-0.5, kv_bounds=bounds)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    assert (got[..., real_d:] == 0).all()


@pytest.mark.parametrize("s", [200, 333])
@pytest.mark.parametrize("h, h_kv", [(4, 2), (8, 1)])
@pytest.mark.parametrize("d", [24, 128])
def test_images_attention_causal_matches_pallas(d, h, h_kv, s):
    """K1's causal path (the LM prefill): GQA, B = 2, ragged valid prefixes
    (one leaves q tiles of padding only), against ``_flash_pallas`` on kv
    expanded to H heads as the JAX decoder expands it."""
    rng = np.random.RandomState(d + h + s)
    q = rng.randn(2, s, h, d).astype(np.float32)
    k, v = (rng.randn(2, s, h_kv, d).astype(np.float32) for _ in range(2))
    valid = np.array([s - 45, s // 3])
    seg = (np.arange(s)[None] < valid[:, None]).astype(np.int32)
    n_rep = h // h_kv
    want = jattn._flash_pallas(
        jnp.asarray(q), jnp.asarray(np.repeat(k, n_rep, 2)),
        jnp.asarray(np.repeat(v, n_rep, 2)), jnp.asarray(seg),
        jnp.asarray(seg), True, d**-0.5, BLOCK, BLOCK, interpret=True)
    imgs = T.flash_images_plain(_t(q), _t(k), _t(v), _t(seg), _t(seg))
    got = T.images_attention_plain(*imgs[:3], _t(seg), _t(seg), d,
                                   causal=True).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    assert (got[seg == 0] == 0).all()


def _step_layouts():
    """(name, seg [S]): valid prefixes (the LM prefill's layout, the two
    ``chip_smoke.py`` lengths among them), two images, and 8 video frames
    of 128 rows: layouts with whole tiles of one segment."""
    out = [(f"prefix{t}_{n}", (np.arange(t) < n).astype(np.int32))
           for t, n in ((1664, 1302), (384, 294), (200, 155), (333, 222))]
    return out + [("full", _layouts(333)["full"]),
                  ("video", _layouts(1040)["video"])]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name, seg", _step_layouts())
def test_flash_steps_mask_free_pairs_are_valid(name, seg, causal):
    """Every (query, key) pair of a mask-free step is valid under
    ``flash_plain``'s segment (and causal) mask, rows past S counted as
    padding; every valid pair lies in a visited tile."""
    s = len(seg)
    visited, mask_free = T.flash_steps_plain(_t(seg), _t(seg), causal)
    n = visited.shape[0] * BLOCK
    rows = np.zeros(n, np.int32)
    rows[:s] = seg
    ok = (rows[:, None] == rows[None]) & (rows[None] > 0)
    if causal:
        ok &= np.arange(n)[:, None] >= np.arange(n)[None]
    tiles = ok.reshape(n // BLOCK, BLOCK, n // BLOCK, BLOCK)
    all_ok, any_ok = tiles.all((1, 3)), tiles.any((1, 3))
    assert not (mask_free.numpy() & ~all_ok).any()
    assert not (any_ok & ~visited.numpy()).any()
    assert mask_free.any()


@pytest.mark.parametrize("t, valid", [(1664, 1302), (384, 294), (200, 155),
                                      (333, 111)])
def test_flash_steps_causal_diagonal_never_mask_free(t, valid):
    seg = _t((np.arange(t) < valid).astype(np.int32))
    visited, mask_free = T.flash_steps_plain(seg, seg, causal=True)
    assert not mask_free.diagonal().any()
    assert not visited.triu(1).any()  # nothing past the diagonal
    live = -(-valid // BLOCK)
    assert visited[:live].diagonal().all()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_steps_padding_q_tiles(causal):
    """Under causal, q tiles of padding rows only visit nothing; without
    it (the ablation's schedule) every q tile visits the full range."""
    t, valid = 384, 150  # q tiles 3-5 hold padding rows only
    seg = _t((np.arange(t) < valid).astype(np.int32))
    visited, _ = T.flash_steps_plain(seg, seg, causal)
    counts = visited.sum(1).tolist()
    assert counts == ([1, 2, 3, 0, 0, 0] if causal else [6] * 6)


@pytest.mark.parametrize("t, valid, free, steps", [(1664, 1302, 190, 231),
                                                   (384, 294, 6, 15)])
def test_flash_steps_shares_at_the_prefill_layouts(t, valid, free, steps):
    """The two LM prefill lengths of the 3B request (orig and selector 0.2):
    visited steps per head and the mask-free ones."""
    seg = _t((np.arange(t) < valid).astype(np.int32))
    visited, mask_free = T.flash_steps_plain(seg, seg, causal=True)
    assert (int(visited.sum()), int(mask_free.sum())) == (steps, free)


@pytest.mark.parametrize("do_exp", [True, False])
@pytest.mark.parametrize("do_mask", [True, False])
def test_images_ablation_matches_jax_bench_kernel(jbench, do_mask,  # noqa: F811
                                                  do_exp):
    """K7's four variants from the images, against the JAX bench kernel."""
    q, k, v, seg = _ablate_inputs()
    want = _jax_variant(jbench, q, k, v, seg, do_mask, do_exp)
    got = _from_images(q, k, v, seg, do_mask=do_mask, do_exp=do_exp)
    tol = dict(atol=3e-5, rtol=1e-4) if do_exp else dict(atol=1e-4,
                                                         rtol=1e-4)
    np.testing.assert_allclose(got, want, **tol)


def test_images_ablation_takes_no_bounds():
    q, k, v, seg = _ablate_inputs()
    with pytest.raises(ValueError, match="no bounds"):
        _from_images(q, k, v, seg, do_exp=False, kv_iters=2)
    with pytest.raises(ValueError, match="no causal"):
        _from_images(q, k, v, seg, do_mask=False, causal=True)


@pytest.mark.parametrize("d, nbytes", [(80, 47_185_920), (128, 75_497_472)])
def test_flash_scratch_holds_three_images_per_layer(d, nbytes):
    """The wgmma route's scratch at the ViT's full layer (S = 6144, 16
    heads): 3 x B x H x ceil(S/64) x 64 x dp bf16 and two tile_segs."""
    scratch = tattn._flash_scratch(1, 16, 16, 6144, 6144, d, "cpu")
    assert sum(x.nbytes for x in scratch[:3]) == nbytes
    assert [x.dtype for x in scratch] == [torch.bfloat16] * 3 + [
        torch.int32] * 2
    assert scratch[3].shape == scratch[4].shape == (1, 96)
    gqa = tattn._flash_scratch(2, 16, 2, 384, 1664, 128, "cpu")
    assert gqa[0].shape == (2, 16, 6, 64 * 128)
    assert gqa[1].shape == gqa[2].shape == (2, 2, 26, 64 * 128)


def test_cpu_calls_count_no_route():
    q, k, v = (_t(x) for x in _qkv(3, 128, 2, 2, 16))
    seg = torch.ones(1, 128, dtype=torch.int32)
    before = dict(tattn.FLASH_ROUTE_LAUNCHES)
    tattn.flash_varlen_fwd(q, k, v, seg, seg)
    tattn.flash_varlen_fwd(q, k, v, seg, seg, causal=True)
    tattn.fullattn_ablate(q, k, v, seg, False, False)
    assert tattn.FLASH_ROUTE_LAUNCHES == before
