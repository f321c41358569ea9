"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test here is marked ``cuda`` and skips without a GPU. The
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Tolerance: every output element within ULP_LIMIT bf16 ulps of the largest
|value| of its row (one head of one query) in the plain output. Rounding
both outputs to bf16 differs by at most 1 such ulp; the plain version
rounds p to bf16 at the final row max and the kernel at the running max,
which adds up to about one more in the tails (the same check as
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from visionselector_tpu_torch.kernels import attention as A

pytestmark = pytest.mark.cuda
ULP_LIMIT = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _rnd(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").bfloat16()


def _seg(s, dev):
    seg = np.zeros(s, np.int32)
    cuts = [0, s // 5, s // 2 + 3, s - s // 6]
    for i in range(3):
        seg[cuts[i]:cuts[i + 1]] = i + 1
    return torch.as_tensor(seg, device=dev)[None]


def _err(got, want):
    """Largest |got - want| in bf16 ulps of its row's largest |want|."""
    g, w = got.float(), want.float()
    amax = w.abs().amax(-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(amax)) - 7)
    ulp = torch.where(amax > 0, ulp, torch.finfo(torch.float32).tiny)
    return ((g - w).abs() / ulp).max().item()


@pytest.mark.parametrize("d", [16, 24, 64, 80, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [64, 200, 333])
def test_flash_matches_plain_ragged_gqa(dev, d, causal, s):
    gen = torch.Generator(device=dev).manual_seed(s + d)
    q = _rnd(gen, 2, s, 8, d)
    k, v = _rnd(gen, 2, s, 2, d), _rnd(gen, 2, s, 2, d)
    seg = _seg(s, dev).repeat(2, 1)
    got = A.flash_varlen_fwd(q, k, v, seg, seg, causal=causal)
    want = A.flash_plain(q, k, v, seg, seg, causal=causal)
    assert _err(got, want) <= ULP_LIMIT
    assert (got[:, seg[0] == 0] == 0).all()


@pytest.mark.parametrize("kv_iters", [None, 1, 2])
def test_flash_bounds_and_kv_iters(dev, kv_iters):
    gen = torch.Generator(device=dev).manual_seed(3)
    s = 512
    q, k, v = (_rnd(gen, 1, s, 4, 80) for _ in range(3))
    seg_np = np.repeat(np.arange(1, 5), s // 4).astype(np.int32)
    seg = torch.as_tensor(seg_np, device=dev)[None]
    bounds = A.segment_block_bounds(seg_np, A.FLASH_BLOCK, A.FLASH_BLOCK)
    got = A.flash_varlen_fwd(q, k, v, seg, seg, kv_bounds=bounds,
                             kv_iters=kv_iters)
    want = A.flash_plain(q, k, v, seg, seg, kv_bounds=bounds,
                         kv_iters=kv_iters)
    assert _err(got, want) <= ULP_LIMIT


def test_flash_reads_strided_views(dev):
    """q/k/v as views of one [S, 3, H, D] slab (the ViT's qkv split)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    s, h, d = 256, 4, 80
    qkv = _rnd(gen, s, 3, h, d)
    q, k, v = (x[None] for x in qkv.unbind(1))
    assert not q.is_contiguous()
    seg = _seg(s, dev)
    got = A.flash_varlen_fwd(q, k, v, seg, seg)
    want = A.flash_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                         seg, seg)
    assert _err(got, want) <= ULP_LIMIT


@pytest.mark.parametrize("d", [16, 24, 64, 80, 128])
def test_diag_matches_plain(dev, d):
    gen = torch.Generator(device=dev).manual_seed(d)
    s, h = 384, 6  # 6 heads: no power of two, items not a multiple of 4
    q, k, v = (_rnd(gen, 2, s, h, d) for _ in range(3))
    seg_np = np.zeros(s, np.int32)
    for w in range(s // 16):
        if w % 5 != 4:
            seg_np[w * 16:w * 16 + 16 - (w % 3)] = w + 1
    seg = torch.as_tensor(seg_np, device=dev)[None].repeat(2, 1)
    got = A.diag_attn_fwd(q, k, v, seg)
    want = A.diag_plain(q, k, v, seg)
    assert _err(got, want) <= ULP_LIMIT
    assert (got[:, seg[0] == 0] == 0).all()


def _diag_layout(s, b):
    """[b, s] segment ids of every tile kind, cycling per 64-row tile: one
    64-row window (uniform), four 16-patch windows with the last two cut
    short (mixed), padding only, one 40-row window then padding (mixed),
    two 32-row windows (mixed); batch row 1 shifted by one tile."""
    rows = []
    for r in range(b):
        seg, nxt = np.zeros(s, np.int32), 1
        for t in range(s // 64):
            kind, base = (t + r) % 5, t * 64
            spans = {0: [(0, 64)], 1: [(0, 16), (16, 32), (32, 46), (48, 60)],
                     2: [], 3: [(0, 40)], 4: [(0, 32), (32, 64)]}[kind]
            for a, e in spans:
                seg[base + a:base + e] = nxt
                nxt += 1
        rows.append(seg)
    return np.stack(rows)


@pytest.mark.parametrize("d", [16, 24, 64, 80, 128])
def test_diag_tile_kinds_and_slab_view(dev, d):
    """B = 2, H = 6, every tile kind, v a strided view of a qkv slab (row
    stride 3 H d), q and k contiguous: within ULP_LIMIT of diag_plain,
    padding rows exactly 0."""
    from visionselector_tpu_torch.kernels import tiles as T

    gen = torch.Generator(device=dev).manual_seed(40 + d)
    b, s, h = 2, 640, 6
    q, k = _rnd(gen, b, s, h, d), _rnd(gen, b, s, h, d)
    v = _rnd(gen, b, s, 3, h, d)[:, :, 2]
    seg = torch.as_tensor(_diag_layout(s, b), device=dev)
    kinds = T.diag_tile_kinds_plain(seg.cpu())
    assert set(kinds.flatten().tolist()) == {T.DIAG_PAD, T.DIAG_UNIFORM,
                                             T.DIAG_MIXED}
    got = A.diag_attn_fwd(q, k, v, seg)
    want = A.diag_plain(q, k, v, seg)
    assert _err(got, want) <= ULP_LIMIT
    assert (got[seg == 0] == 0).all()


@pytest.mark.parametrize("b, s, h", [(1, 64, 1), (3, 192, 5), (1, 6144, 16)])
def test_diag_persistent_grid_shapes(dev, b, s, h):
    """Fewer items than the grid's blocks, a few, and the main path's 1,536
    (several per block): every item is computed once."""
    gen = torch.Generator(device=dev).manual_seed(s + h)
    q, k, v = (_rnd(gen, b, s, h, 80) for _ in range(3))
    seg = torch.as_tensor(_diag_layout(s, b), device=dev)
    got = A.diag_attn_fwd(q, k, v, seg)
    want = A.diag_plain(q, k, v, seg)
    assert _err(got, want) <= ULP_LIMIT
    assert (got[seg == 0] == 0).all()


def test_diag_packed_padded_views(dev):
    """The "packed" window layer: heads of 80 zero-padded to dp = 128, q
    and k contiguous, v a view of the padded qkv slab, the real 80 ** -0.5
    scale, the window-aligned layout of a 420x728 image: within ULP_LIMIT
    of diag_plain, padding rows and pad columns exactly 0."""
    from visionselector_tpu_torch.preprocess.indices import (
        build_vision_batch,
    )

    grid = np.asarray([[1, 30, 52]])
    n = int(np.prod(grid))
    vb = build_vision_batch(np.zeros((n, 1), np.float32), grid, pad_to=2048,
                            align_windows=True)
    assert vb.window_diag
    seg = torch.as_tensor(np.asarray(vb.window_seg_ids), device=dev)[None]
    s, h, d, dp = seg.shape[1], 16, 80, 128
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k = _rnd(gen, 1, s, h, dp), _rnd(gen, 1, s, h, dp)
    slab = _rnd(gen, s, 3, h, dp)
    for x in (q, k, slab):
        x[..., d:] = 0
    v = slab[:, 2][None]
    got = A.diag_attn_fwd(q, k, v, seg, scale=d**-0.5)
    want = A.diag_plain(q, k, v, seg, scale=d**-0.5)
    assert _err(got, want) <= ULP_LIMIT
    assert (got[seg == 0] == 0).all()
    assert (got[..., d:] == 0).all()


def test_diag_mixed_tile_forced_mask_free_fails(dev):
    """The tile-kind hook: the true kinds reproduce the kernel; a mixed
    tile forced onto the mask-free path is a planted fault the check must
    reject."""
    from visionselector_tpu_torch.kernels import tiles as T

    gen = torch.Generator(device=dev).manual_seed(9)
    b, s, h, d = 1, 320, 4, 80
    q, k, v = (_rnd(gen, b, s, h, d) for _ in range(3))
    seg = torch.as_tensor(_diag_layout(s, b), device=dev)
    want = A.diag_plain(q, k, v, seg)
    kinds = T.diag_tile_kinds_plain(seg.cpu())
    same = A._launch_diag(q, k, v, seg, tile_kind=kinds)
    assert _err(same, want) <= ULP_LIMIT
    forced = kinds.clone()
    mixed = int((kinds[0] == T.DIAG_MIXED).nonzero()[0])
    forced[0, mixed] = T.DIAG_UNIFORM
    bad = A._launch_diag(q, k, v, seg, tile_kind=forced)
    assert _err(bad, want) > ULP_LIMIT


def test_diag_rejects_misaligned_views(dev):
    gen = torch.Generator(device=dev).manual_seed(11)
    seg = _seg(128, dev)
    q, k = _rnd(gen, 1, 128, 2, 80), _rnd(gen, 1, 128, 2, 80)
    v = _rnd(gen, 1, 128, 2, 84)[..., :80]  # head stride 84: not 16-byte
    with pytest.raises(ValueError, match="16-byte"):
        A.diag_attn_fwd(q, k, v, seg)
    with pytest.raises(ValueError, match="multiple of 64"):
        A.diag_attn_fwd(q[:, :100], k[:, :100], k[:, :100], seg[:, :100])
    with pytest.raises(ValueError, match="tile_kind"):
        A._launch_diag(q, k, k, seg, tile_kind=np.zeros((1, 3), np.int32))


def test_wrappers_count_launches_and_reject_bad_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (_rnd(gen, 1, 128, 2, 80) for _ in range(3))
    seg = _seg(128, dev)
    f0, d0 = A.FLASH_LAUNCHES, A.DIAG_LAUNCHES
    A.attention(q, k, v, seg, seg)
    A.attention_diag(q, k, v, seg)
    A.attention(q, k, v, seg, seg, impl="plain")
    assert (A.FLASH_LAUNCHES - f0, A.DIAG_LAUNCHES - d0) == (1, 1)
    with pytest.raises(ValueError, match="bfloat16"):
        A.flash_varlen_fwd(q.float(), k.float(), v.float(), seg, seg)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_varlen_fwd(q[..., :48], k[..., :48], v[..., :48], seg, seg)
    with pytest.raises(ValueError, match="bounds"):
        A.flash_varlen_fwd(q, k, v, seg, seg,
                           kv_bounds=np.zeros((1, 2), np.int32))
    with pytest.raises(ValueError, match="block"):
        A.diag_attn_fwd(q, k, v, seg, block_q=128)
    with pytest.raises(ValueError, match="devices"):
        A.flash_varlen_fwd(q, k, v, seg.cpu(), seg.cpu())


def test_tiny_engine_kernels_match_plain_path(dev):
    """The whole tiny slice on the card: kernel path against the plain
    attention path (bf16 weights)."""
    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.models.qwen25vl.weights import init_params
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    cfg = qwen25vl_tiny()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    rng = np.random.RandomState(0)
    img = (rng.rand(224, 280, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens([100, 200], [300, 400], grid)
    for sel in (True, False):
        kern = QwenVLEngine(cfg, params, use_selector=sel, device=dev)
        plain = QwenVLEngine(cfg, params, use_selector=sel, device=dev,
                             attn_impl="plain")
        f0 = A.FLASH_LAUNCHES
        a = kern.generate(ids, px, grid, max_new_tokens=4)
        assert A.FLASH_LAUNCHES - f0 == 2 + cfg.text.num_hidden_layers
        b = plain.generate(ids, px, grid, max_new_tokens=4)
        assert a.prefill_len == b.prefill_len
        assert torch.isfinite(a.logits).all()
        scale = b.logits.abs().max().item()
        assert (a.logits - b.logits).abs().max().item() <= 0.1 * scale


def _decode_inputs(gen, b, t_c, hq, h_kv, t, d, quant):
    q = _rnd(gen, b, t_c, hq, d)
    if quant:
        k = torch.randint(-127, 128, (b, t, h_kv, d), generator=gen,
                          device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, (b, t, h_kv, d), generator=gen,
                          device="cuda", dtype=torch.int8)
        ks = torch.rand(b, t, h_kv, generator=gen, device="cuda") * 0.02
        vs = torch.rand(b, t, h_kv, generator=gen, device="cuda") * 0.02
        return q, k, v, ks + 1e-3, vs + 1e-3
    return q, _rnd(gen, b, t, h_kv, d), _rnd(gen, b, t, h_kv, d), None, None


@pytest.mark.parametrize("d", [24, 128])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("t_c", [1, 4])
@pytest.mark.parametrize("t", [333, 2048])
def test_decode_matches_plain(dev, d, quant, t_c, t):
    """Lengths at tile edges and the ragged last tile; GQA n_rep 8."""
    gen = torch.Generator(device=dev).manual_seed(d + t_c + quant + t)
    q, k, v, ks, vs = _decode_inputs(gen, 6, t_c, 16, 2, t, d, quant)
    base = torch.tensor([0, 63, 64, 65, t // 2, t - t_c], device=dev)
    got = A.decode_blocked_fwd(q, k, v, base, None, ks, vs)
    want = A.decode_blocked_plain(q, k, v, base, None, ks, vs)
    assert _err(got, want) <= ULP_LIMIT
    assert A.chunk_decode_attention(q, k, v, base, k_scale=ks,
                                    v_scale=vs).equal(got)


def test_decode_reads_pool_layer_views_and_rejects_faults(dev):
    """A layer of a [L, S, T, H, D] pool (and its scales) is read through
    strides; a slot's length cut by one, or its last live tile dropped,
    fails the tolerance."""
    gen = torch.Generator(device=dev).manual_seed(11)
    pool = torch.randint(-127, 128, (3, 8, 2048, 2, 128), generator=gen,
                         device=dev, dtype=torch.int8)
    scales = torch.rand(3, 8, 2048, 2, generator=gen, device=dev) * 0.02
    q = _rnd(gen, 8, 1, 16, 128)
    base = torch.tensor([1, 63, 64, 65, 300, 1302, 1900, 2047], device=dev)
    k, v, ks, vs = pool[1], pool[2], scales[1], scales[2]
    got = A.decode_blocked_fwd(q, k, v, base, None, ks, vs)
    want = A.decode_blocked_plain(q, k, v, base, None, ks, vs)
    assert _err(got, want) <= ULP_LIMIT
    cut = base.clone()
    cut[5] -= 1
    assert _err(A.decode_blocked_fwd(q, k, v, cut, None, ks, vs),
                want) > ULP_LIMIT
    tile_cut = torch.div(base, 64, rounding_mode="floor") * 64 - 1
    assert _err(A.decode_blocked_fwd(q, k, v, tile_cut, None, ks, vs),
                want) > ULP_LIMIT
    bf = _rnd(gen, 2, 8, 2048, 2, 128)
    got = A.decode_blocked_fwd(q, bf[0], bf[1], base)
    assert _err(got, A.decode_blocked_plain(q, bf[0], bf[1], base)) \
        <= ULP_LIMIT


def test_decode_counts_launches_and_rejects_bad_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k, v, ks, vs = _decode_inputs(gen, 2, 1, 8, 2, 128, 128, True)
    base = torch.tensor([5, 100], device=dev)
    n0 = A.DECODE_LAUNCHES
    A.decode_attention(q, k, v, base + 1, k_scale=ks, v_scale=vs)
    A.decode_attention(q, k, v, base + 1, k_scale=ks, v_scale=vs,
                       impl="plain")
    assert A.DECODE_LAUNCHES - n0 == 1
    with pytest.raises(ValueError, match="scales"):
        A.decode_blocked_fwd(q, k, v, base, None, ks, None)
    with pytest.raises(ValueError, match="bfloat16 or int8"):
        A.decode_blocked_fwd(q, k.float(), v.float(), base)
    with pytest.raises(ValueError, match="head dim"):
        A.decode_blocked_fwd(q[..., :48], k[..., :48], v[..., :48], base,
                             None, ks, vs)
    with pytest.raises(ValueError, match="devices"):
        A.decode_blocked_fwd(q, k, v, base.cpu(), None, ks, vs)


def _decode_bases(b, t, t_c, dev):
    """Base lengths at tile edges, the ragged last tile and 0."""
    edge = [0, 1, 63, 64, 65, t // 2, t - t_c - 1, t - t_c]
    return torch.tensor(edge[-b:] if b < len(edge) else edge, device=dev)


@pytest.mark.parametrize("d", [16, 24, 64, 80, 128])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("t_c", [1, 4, 9])
def test_decode_matches_split_plain(dev, d, quant, b, t_c):
    """The cluster kernel against its schedule's plain mirror (same
    cluster size) and against the plain version: every head dim (int8 at
    D = 24 takes 8-byte copies), one slot and eight, t_c 9 makes 72 rows
    per kv head, two row groups."""
    gen = torch.Generator(device=dev).manual_seed(d * 7 + t_c + 3 * b + quant)
    t = 700
    q, k, v, ks, vs = _decode_inputs(gen, b, t_c, 16, 2, t, d, quant)
    base = _decode_bases(b, t, t_c, dev)
    got = A.decode_blocked_fwd(q, k, v, base, None, ks, vs)
    cluster = A.decode_cluster_size(dev, b, t_c, 16, 2, d, quant)
    assert 1 <= cluster <= A.DECODE_MAX_CLUSTER
    split = A.decode_split_plain(q, k, v, base, None, ks, vs, cluster)
    want = A.decode_blocked_plain(q, k, v, base, None, ks, vs)
    assert _err(got, split) <= ULP_LIMIT
    assert _err(got, want) <= ULP_LIMIT
    assert torch.isfinite(got).all()


def test_decode_merge_fault_fails(dev):
    """The last rank's share (each slot's last live tile) left out of the
    cluster merge: the kernel agrees with the mirror's same fault and fails
    the tolerance."""
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v, _, _ = _decode_inputs(gen, 8, 1, 16, 2, 2048, 128, False)
    base = torch.tensor([1, 63, 64, 65, 300, 1302, 1900, 2047], device=dev)
    cluster = A.decode_cluster_size(dev, 8, 1, 16, 2, 128, False)
    want = A.decode_blocked_plain(q, k, v, base)
    bad = A._decode_launch(q, k, v, base, drop_rank=cluster - 1)
    assert _err(bad, want) > ULP_LIMIT
    assert _err(bad, A.decode_split_plain(q, k, v, base, cluster=cluster,
                                          drop_rank=cluster - 1)) <= ULP_LIMIT


@pytest.mark.parametrize("quant", [False, True])
def test_decode_cuda_graph_replays_new_lengths(dev, quant):
    """One decode launch captured in a CUDA graph, replayed after base_len
    changes in place: equal to eager at both lengths, so the launch reads
    lengths on the device only."""
    gen = torch.Generator(device=dev).manual_seed(22 + quant)
    q, k, v, ks, vs = _decode_inputs(gen, 8, 1, 16, 2, 2048, 128, quant)
    base = torch.tensor([1, 63, 64, 65, 300, 1302, 1900, 2047], device=dev)
    first = A.decode_blocked_fwd(q, k, v, base, None, ks, vs)  # warm-up
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = A.decode_blocked_fwd(q, k, v, base, None, ks, vs)
    torch.cuda.current_stream().wait_stream(stream)
    for lens in ([1, 63, 64, 65, 300, 1302, 1900, 2047],
                 [700, 5, 129, 2040, 0, 64, 1000, 17]):
        base.copy_(torch.tensor(lens, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        eager = A.decode_blocked_fwd(q, k, v, base, None, ks, vs)
        assert out.equal(eager)
        assert _err(out, A.decode_blocked_plain(q, k, v, base, None, ks,
                                                vs)) <= ULP_LIMIT
    assert not first.equal(out)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_tiny_batcher_runs_the_decode_kernel(dev, kv_quant):
    """The continuous batcher on the card: every decode step of every
    chunk launches the kernel once per layer, and greedy tokens stay in
    range."""
    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
    )
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.models.qwen25vl.weights import init_params

    cfg = qwen25vl_tiny()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    eng = QwenVLEngine(cfg, params, device=dev)
    n0 = A.DECODE_LAUNCHES
    bat = ContinuousBatcher(eng, n_slots=2, t_max=256, chunk=4,
                            kv_quant=kv_quant)
    try:
        res = [bat.submit(dict(input_ids=np.arange(5, 5 + n)), 9, (-1,),
                          temperature=0.7 * (n % 2), seed=n)
               for n in (7, 20)]
    finally:
        bat.shutdown()
    steps = bat.stats["chunks"] * 4
    assert A.DECODE_LAUNCHES - n0 == cfg.text.num_hidden_layers * steps
    assert all(len(r.tokens) == 9 and max(r.tokens) < cfg.text.vocab_size
               for r in res)


def _fused_inputs(gen, s, h, d):
    """A qkv slab, bf16 cos/sin of random (h, w) positions, and window- and
    full-attention segments with a padding tail."""
    from visionselector_tpu_torch.models.qwen25vl.vit import (
        vision_rotary_cos_sin,
    )

    qkv = _rnd(gen, s, 3 * h * d)
    pos = torch.randint(0, 40, (s, 2), generator=gen, device="cuda")
    cos, sin = (x.bfloat16() for x in vision_rotary_cos_sin(pos, d))
    wseg = np.zeros(s, np.int32)
    r, i = 0, 1
    while r + 64 <= s - 20:
        n = 16 + (i * 23) % 49
        wseg[r:r + n] = i
        r, i = r + n, i + 1
    return qkv, cos, sin, {"window": wseg, "full": _seg(s, "cpu")[0].numpy()}


@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("kind", ["window", "full"])
@pytest.mark.parametrize("s", [256, 333])
def test_fused_matches_plain(dev, d, kind, s):
    """K6 against fused_plain: window and full bounds, a ragged last tile
    (333 rows) and padding rows."""
    from visionselector_tpu_torch.kernels import fused_vit_attn as F_

    gen = torch.Generator(device=dev).manual_seed(s + d)
    h = 4
    qkv, cos, sin, segs = _fused_inputs(gen, s, h, d)
    seg_np = segs[kind]
    seg = torch.as_tensor(seg_np, device=dev)
    bounds = A.segment_block_bounds(seg_np, 64, 64) if s % 64 == 0 else None
    n0 = F_.FUSED_LAUNCHES
    got = F_.fused_vit_attention(qkv, seg, cos, sin, bounds, h, d)
    assert F_.FUSED_LAUNCHES - n0 == 1
    want = F_.fused_plain(qkv, seg, cos, sin, bounds, h, d)
    assert _err(got.view(s, h, d), want.view(s, h, d)) <= ULP_LIMIT
    assert (got[seg == 0] == 0).all()


def test_fused_planted_faults_fail(dev):
    """A kv tile dropped from the bounds, and k rotated with the next
    row's cos/sin, both fail the tolerance."""
    from visionselector_tpu_torch.kernels import fused_vit_attn as F_
    from visionselector_tpu_torch.models.qwen25vl.vit import apply_rotary

    gen = torch.Generator(device=dev).manual_seed(21)
    s, h, d = 512, 4, 80
    qkv, cos, sin, segs = _fused_inputs(gen, s, h, d)
    seg = torch.as_tensor(segs["full"], device=dev)
    bounds = torch.as_tensor(A.segment_block_bounds(segs["full"], 64, 64),
                             device=dev)
    got = F_.fused_vit_attention(qkv, seg, cos, sin, bounds, h, d)
    want = F_.fused_plain(qkv, seg, cos, sin, bounds, h, d)
    assert _err(got.view(s, h, d), want.view(s, h, d)) <= ULP_LIMIT
    live = (bounds[:, 1] > bounds[:, 0]).int()
    bad = bounds - live[:, None] * torch.tensor([0, 1], device=dev)
    cut = F_.fused_vit_attention(qkv, seg, cos, sin, bad, h, d)
    assert _err(cut.view(s, h, d), want.view(s, h, d)) > ULP_LIMIT
    q, k, v = qkv.view(s, 3, h, d).unbind(1)
    q, _ = apply_rotary(q, q, cos, sin)
    _, k = apply_rotary(k, k, cos.roll(-1, 0), sin.roll(-1, 0))
    shifted = A.flash_plain(q[None], k[None], v[None], seg[None], seg[None],
                            kv_bounds=bounds)[0]
    assert _err(got.view(s, h, d), shifted) > ULP_LIMIT
    with pytest.raises(ValueError, match="width"):
        F_.fused_vit_attention(qkv[:, :-8], seg, cos, sin, bounds, h, d)


def _tile_seg_np(seg):
    """Numpy reference of the prologue's tile_seg: a 64-row tile's segment
    id if all its rows (rows past S count as 0) share one id > 0, else -1."""
    t = np.zeros(-(-len(seg) // 64) * 64, np.int32)
    t[:len(seg)] = seg
    t = t.reshape(-1, 64)
    return np.where((t == t[:, :1]).all(1) & (t[:, 0] > 0), t[:, 0], -1)


@pytest.mark.parametrize("d", [16, 24, 64, 80, 128])
def test_fused_prologue_images_bit_exact(dev, d):
    """The rotary prologue's q, k and v^T tile images equal prologue_plain
    (apply_rotary, packed) bit for bit, zero pads included; tile_seg
    equals numpy; the main loop's output is within ULP_LIMIT."""
    from visionselector_tpu_torch.kernels import fused_vit_attn as F_

    gen = torch.Generator(device=dev).manual_seed(100 + d)
    s, h = 333, 3
    qkv, cos, sin, segs = _fused_inputs(gen, s, h, d)
    seg = torch.as_tensor(segs["full"], device=dev)
    out, scratch = F_._launch(qkv, seg, cos, sin, None, h, d, d**-0.5)
    for got, want in zip(scratch[:3], F_.prologue_plain(qkv, cos, sin, h, d)):
        assert got.shape == want.shape and torch.equal(got, want)
    np.testing.assert_array_equal(scratch[3].cpu().numpy(),
                                  _tile_seg_np(segs["full"]))
    want = F_.fused_plain(qkv, seg, cos, sin, None, h, d)
    assert _err(out.view(s, h, d), want.view(s, h, d)) <= ULP_LIMIT
    assert (out[seg == 0] == 0).all()


def _straddling(layout):
    """(S, seg, bounds or None): segments that cross 64-row tiles."""
    if layout == "windows40":  # 40-row windows, 32 padding rows
        s = 512
        seg = np.where(np.arange(s) < s - 32, 1 + np.arange(s) // 40, 0)
    elif layout == "frames8":  # 8 frames of 60 rows, 32 padding rows
        s = 512
        seg = np.where(np.arange(s) < 480, 1 + np.arange(s) // 60, 0)
    else:  # ragged S = 333: two images, the last 20 rows padding
        s = 333
        seg = np.where(np.arange(s) < 150, 1, 2)
        seg[s - 20:] = 0
    seg = seg.astype(np.int32)
    if layout == "ragged_nobounds":
        return s, seg, None
    padded = np.zeros(-(-s // 64) * 64, np.int32)
    padded[:s] = seg
    return s, seg, A.segment_block_bounds(padded, 64, 64)


@pytest.mark.parametrize("layout", ["windows40", "frames8", "ragged_bounds",
                                    "ragged_nobounds"])
def test_fused_straddling_segments_take_the_masked_path(dev, layout):
    """Tiles that segments straddle get tile_seg -1 (the masked step) and
    the output stays within ULP_LIMIT of fused_plain."""
    from visionselector_tpu_torch.kernels import fused_vit_attn as F_

    gen = torch.Generator(device=dev).manual_seed(7)
    s, seg_np, bounds = _straddling(layout)
    h, d = 4, 80
    qkv, cos, sin, _ = _fused_inputs(gen, s, h, d)
    seg = torch.as_tensor(seg_np, device=dev)
    out, scratch = F_._launch(qkv, seg, cos, sin, bounds, h, d, d**-0.5)
    want_ts = _tile_seg_np(seg_np)
    np.testing.assert_array_equal(scratch[3].cpu().numpy(), want_ts)
    assert (want_ts == -1).sum() >= 2
    want = F_.fused_plain(qkv, seg, cos, sin, bounds, h, d)
    assert _err(out.view(s, h, d), want.view(s, h, d)) <= ULP_LIMIT
    assert (out[seg == 0] == 0).all()


def test_fused_straddling_tile_forced_mask_free_fails(dev):
    """Planted fault: tile_seg marks tile 0 of 40-row windows (rows of
    segments 1 and 2) uniform, so its step skips the mask: the check must
    reject the output."""
    from visionselector_tpu_torch.kernels import fused_vit_attn as F_

    gen = torch.Generator(device=dev).manual_seed(8)
    s, seg_np, bounds = _straddling("windows40")
    h, d = 4, 80
    qkv, cos, sin, _ = _fused_inputs(gen, s, h, d)
    seg = torch.as_tensor(seg_np, device=dev)
    forced = torch.as_tensor(_tile_seg_np(seg_np), device=dev)
    assert forced[0] == -1
    forced[0] = 1
    bad, _ = F_._launch(qkv, seg, cos, sin, bounds, h, d, d**-0.5,
                        tile_seg=forced)
    want = F_.fused_plain(qkv, seg, cos, sin, bounds, h, d)
    assert _err(bad.view(s, h, d), want.view(s, h, d)) > ULP_LIMIT


@pytest.mark.parametrize("real_d", [16, 80])
@pytest.mark.parametrize("causal", [False, True])
def test_packed_matches_plain_and_keeps_pad_zero(dev, real_d, causal):
    """K3: heads of real_d zero-padded to 128 in [1, S, H*128] slabs (q, k,
    v column slices of one slab), GQA 8/2, the real scale; pad columns of
    the output exactly 0; noise in the pad columns of q and k fails the
    tolerance."""
    gen = torch.Generator(device=dev).manual_seed(real_d + causal)
    s, h, h_kv, dp = 333, 8, 2, 128
    slab = torch.zeros(1, s, (h + 2 * h_kv), dp, device=dev,
                       dtype=torch.bfloat16)
    slab[..., :real_d] = _rnd(gen, 1, s, h + 2 * h_kv, real_d)
    q, k, v = slab.flatten(2).split([h * dp, h_kv * dp, h_kv * dp], -1)
    seg = _seg(s, dev)
    kw = dict(causal=causal, scale=real_d**-0.5)
    p0, f0 = A.PACKED_LAUNCHES, A.FLASH_LAUNCHES
    got = A.flash_packed_fwd(q, k, v, seg, seg, h, h_kv, dp, **kw)
    assert (A.PACKED_LAUNCHES - p0, A.FLASH_LAUNCHES - f0) == (1, 0)
    want = A.flash_packed_plain(q, k, v, seg, seg, h, h_kv, dp, **kw)
    got, want = got.view(1, s, h, dp), want.view(1, s, h, dp)
    assert _err(got, want) <= ULP_LIMIT
    assert (got[..., real_d:] == 0).all() and (got[:, seg[0] == 0] == 0).all()
    noisy = slab.clone()
    noisy[..., real_d:] = _rnd(gen, 1, s, h + 2 * h_kv, dp - real_d)
    nq, nk, _ = noisy.flatten(2).split([h * dp, h_kv * dp, h_kv * dp], -1)
    bad = A.flash_packed_fwd(nq, nk, v, seg, seg, h, h_kv, dp, **kw)
    assert _err(bad.view(1, s, h, dp), want) > ULP_LIMIT


@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("do_mask", [True, False])
@pytest.mark.parametrize("do_exp", [True, False])
def test_ablate_matches_plain(dev, d, do_mask, do_exp):
    """K7: the four compile-time variants, every tile visited, padding
    rows; S must be a multiple of 64."""
    gen = torch.Generator(device=dev).manual_seed(d + 2 * do_mask + do_exp)
    s, h = 320, 4
    q, k, v = (_rnd(gen, 1, s, h, d) * 0.3 for _ in range(3))
    seg = torch.ones(1, s, dtype=torch.int32, device=dev)
    seg[:, -40:] = 0
    n0 = A.ABLATE_LAUNCHES
    got = A.fullattn_ablate(q, k, v, seg, do_mask, do_exp)
    assert A.ABLATE_LAUNCHES - n0 == 1
    want = A.ablate_plain(q, k, v, seg, do_mask, do_exp)
    assert _err(got, want) <= ULP_LIMIT
    if do_mask:
        assert (got[:, -40:] == 0).all()
    with pytest.raises(ValueError, match="multiple"):
        A.fullattn_ablate(q[:, :300], k[:, :300], v[:, :300], seg[:, :300])


@pytest.mark.parametrize("variant", ["fused", "packed"])
def test_tiny_engine_variants_launch_counts(dev, variant):
    """The tiny engine under each attention configuration: per image
    prefill, fused = 4 fused + 2 flash (decoder) and no diag; packed = 2
    diag + 2 packed (the ViT full layers; the tiny decoder's head dim 24
    keeps the flash entry) ; first-token logits within 0.1 of the plain
    path's range. Padded weights raise."""
    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.kernels import fused_vit_attn as F_
    from visionselector_tpu_torch.models.qwen25vl.model import (
        QwenVLEngine,
        QwenVLParams,
    )
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        init_params,
        pad_vit_head_dim,
    )
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    cfg = qwen25vl_tiny()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    rng = np.random.RandomState(0)
    img = (rng.rand(224, 280, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens([100, 200], [300, 400], grid)
    eng = QwenVLEngine(cfg, params, device=dev, attn_variant=variant)
    counts = lambda: (F_.FUSED_LAUNCHES, A.FLASH_LAUNCHES,  # noqa: E731
                      A.DIAG_LAUNCHES, A.PACKED_LAUNCHES)
    c0 = counts()
    a = eng.generate(ids, px, grid, max_new_tokens=1)
    got = tuple(x - y for x, y in zip(counts(), c0))
    assert got == {"fused": (4, 2, 0, 0), "packed": (0, 2, 2, 2)}[variant]
    b = QwenVLEngine(cfg, params, device=dev, attn_variant=variant,
                     attn_impl="plain").generate(ids, px, grid,
                                                 max_new_tokens=1)
    scale = b.logits.abs().max().item()
    assert (a.logits - b.logits).abs().max().item() <= 0.1 * scale
    padded = QwenVLParams(pad_vit_head_dim(params.visual, cfg.vision),
                          params.lm, params.scorer)
    with pytest.raises(ValueError, match="unpadded"):
        QwenVLEngine(cfg, padded, device=dev, attn_variant=variant)


@pytest.mark.parametrize("d", [16, 24, 64, 80, 128])
def test_flash_prologue_images_bit_exact(dev, d):
    """The flash route's prologue (no rotation): q, k and v^T tile images
    and both tile_segs equal flash_images_plain bit for bit, zero pads
    included, for GQA 4/2, B = 2 and Sq = 200 against Sk = 333; the main
    loop's output is within ULP_LIMIT of flash_plain."""
    from visionselector_tpu_torch.kernels import tiles as T

    gen = torch.Generator(device=dev).manual_seed(200 + d)
    sq, sk = 200, 333
    q = _rnd(gen, 2, sq, 4, d)
    k, v = _rnd(gen, 2, sk, 2, d), _rnd(gen, 2, sk, 2, d)
    q_seg = torch.cat([_seg(sq, dev), _seg(sq, dev).flip(1)])
    kv_seg = torch.cat([_seg(sk, dev), _seg(sk, dev).flip(1)])
    out, scratch = A._launch_flash("flash_varlen_fwd", q, k, v, q_seg, kv_seg,
                                   False, None, None, None)
    want_imgs = T.flash_images_plain(q, k, v, q_seg, kv_seg)
    for got, want in zip(scratch, want_imgs):
        assert got.shape == want.shape and torch.equal(got, want)
    for i in range(2):
        np.testing.assert_array_equal(scratch[4][i].cpu().numpy(),
                                      _tile_seg_np(kv_seg[i].cpu().numpy()))
    want = A.flash_plain(q, k, v, q_seg, kv_seg)
    assert _err(out, want) <= ULP_LIMIT
    assert (out[q_seg == 0] == 0).all()


def test_flash_routes_are_counted(dev):
    """Every kernel call (flash and packed, causal or not, the ablation)
    takes the wgmma route; plain calls count nothing."""
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v = (_rnd(gen, 1, 128, 2, 64) for _ in range(3))
    seg = _seg(128, dev)
    before = dict(A.FLASH_ROUTE_LAUNCHES)
    A.flash_varlen_fwd(q, k, v, seg, seg)
    A.flash_varlen_fwd(q, k, v, seg, seg, causal=True)
    A.flash_packed_fwd(q.flatten(2), k.flatten(2), v.flatten(2), seg, seg, 2,
                       2, 64)
    A.flash_packed_fwd(q.flatten(2), k.flatten(2), v.flatten(2), seg, seg, 2,
                       2, 64, causal=True)
    A.fullattn_ablate(q, k, v, seg, False, True)
    A.attention(q, k, v, seg, seg, impl="plain")
    got = {r: A.FLASH_ROUTE_LAUNCHES[r] - before[r] for r in before}
    assert got == {"wgmma": 5}


def test_flash_misaligned_views_raise(dev):
    """The prologue reads 16 bytes at a time: a base pointer or a row or
    head stride off 16 bytes raises ValueError, never falls back."""
    gen = torch.Generator(device=dev).manual_seed(32)
    s, h, d = 128, 2, 80
    seg = _seg(s, dev)
    good = _rnd(gen, 1, s, h, d)
    shifted = _rnd(gen, s * h * d + 4)[4:].view(1, s, h, d)  # base + 8 B
    narrow = _rnd(gen, 1, s, h, d + 4)[..., :d]  # head stride 84
    f0 = A.FLASH_LAUNCHES
    for bad in (shifted, narrow):
        with pytest.raises(ValueError, match="16-byte"):
            A.flash_varlen_fwd(bad, good, good, seg, seg)
        with pytest.raises(ValueError, match="16-byte"):
            A.flash_varlen_fwd(good, good, bad, seg, seg)
    assert A.FLASH_LAUNCHES == f0


@pytest.mark.parametrize("layout", ["windows40", "frames8", "ragged_bounds",
                                    "ragged_nobounds"])
def test_flash_straddling_segments_take_the_masked_path(dev, layout):
    """Segments that cross 64-row tiles: those tiles get tile_seg -1 (the
    masked step) and the output stays within ULP_LIMIT of flash_plain."""
    gen = torch.Generator(device=dev).manual_seed(33)
    s, seg_np, bounds = _straddling(layout)
    q, k, v = (_rnd(gen, 1, s, 4, 80) for _ in range(3))
    seg = torch.as_tensor(seg_np, device=dev)[None]
    out, scratch = A._launch_flash("flash_varlen_fwd", q, k, v, seg, seg,
                                   False, None, bounds, None)
    want_ts = _tile_seg_np(seg_np)
    np.testing.assert_array_equal(scratch[3][0].cpu().numpy(), want_ts)
    assert (want_ts == -1).sum() >= 2
    want = A.flash_plain(q, k, v, seg, seg, kv_bounds=bounds)
    assert _err(out, want) <= ULP_LIMIT
    assert (out[:, seg[0] == 0] == 0).all()


def test_flash_planted_faults_fail(dev):
    """A kv tile dropped from the bounds, and a straddling tile (rows of
    segments 1 and 2) forced onto the mask-free step, both fail the
    tolerance on the wgmma route."""
    gen = torch.Generator(device=dev).manual_seed(34)
    s, seg_np, bounds = _straddling("windows40")
    q, k, v = (_rnd(gen, 1, s, 4, 80) for _ in range(3))
    seg = torch.as_tensor(seg_np, device=dev)[None]
    bounds = torch.as_tensor(bounds, device=dev)
    want = A.flash_plain(q, k, v, seg, seg, kv_bounds=bounds)
    got = A.flash_varlen_fwd(q, k, v, seg, seg, kv_bounds=bounds)
    assert _err(got, want) <= ULP_LIMIT
    live = (bounds[:, 1] > bounds[:, 0]).int()
    cut = bounds - live[:, None] * torch.tensor([0, 1], device=dev)
    assert _err(A.flash_varlen_fwd(q, k, v, seg, seg, kv_bounds=cut),
                want) > ULP_LIMIT
    forced = torch.as_tensor(_tile_seg_np(seg_np), device=dev)[None]
    assert forced[0, 0] == -1
    forced[0, 0] = 1
    bad, _ = A._launch_flash("flash_varlen_fwd", q, k, v, seg, seg, False,
                             None, bounds, None, tile_seg=(forced, forced))
    assert _err(bad, want) > ULP_LIMIT


@pytest.mark.parametrize("variant", [None, "fused", "packed"])
def test_tiny_engine_flash_routes(dev, variant):
    """Per image prefill of the tiny engine (2 ViT full layers, 2 decoder
    layers): the ViT's full layers (flash or packed) and the decoder's
    causal prefill all take the wgmma route; "fused" runs its own kernel in
    the ViT."""
    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.models.qwen25vl.weights import init_params
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    cfg = qwen25vl_tiny()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    rng = np.random.RandomState(0)
    img = (rng.rand(224, 280, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens([100, 200], [300, 400], grid)
    eng = QwenVLEngine(cfg, params, device=dev, attn_variant=variant)
    before = dict(A.FLASH_ROUTE_LAUNCHES)
    eng.generate(ids, px, grid, max_new_tokens=1)
    got = {r: A.FLASH_ROUTE_LAUNCHES[r] - before[r] for r in before}
    n_full = len(cfg.vision.fullatt_block_indexes)
    n_lm = cfg.text.num_hidden_layers
    assert got == {"wgmma": (0 if variant == "fused" else n_full) + n_lm}


def _prefix_inputs(gen, b, t, h, h_kv, d, valid):
    """q [b, t, h, d], k, v [b, t, h_kv, d] and valid-prefix segments (the
    LM prefill's layout), one length per batch row."""
    q = _rnd(gen, b, t, h, d)
    k, v = _rnd(gen, b, t, h_kv, d), _rnd(gen, b, t, h_kv, d)
    seg = (torch.arange(t, device="cuda")[None]
           < torch.tensor(valid, device="cuda")[:, None]).int()
    return q, k, v, seg


@pytest.mark.parametrize("d", A.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("h, h_kv", [(16, 2), (4, 2)])
@pytest.mark.parametrize("t", [200, 333, 1664])
def test_flash_causal_wgmma_matches_plain(dev, d, h, h_kv, t):
    """K1's causal path on the wgmma route: GQA, B = 2, ragged valid
    prefixes (the second leaves q tiles of padding only, which visit no kv
    tile): images bit for bit equal to flash_images_plain, the output
    within ULP_LIMIT of flash_plain, padding rows exactly 0."""
    from visionselector_tpu_torch.kernels import tiles as T

    gen = torch.Generator(device=dev).manual_seed(300 + d + h + t)
    q, k, v, seg = _prefix_inputs(gen, 2, t, h, h_kv, d, [t - 45, t // 3])
    out, scratch = A._launch_flash("flash_varlen_fwd", q, k, v, seg, seg,
                                   True, None, None, None)
    for got, want in zip(scratch, T.flash_images_plain(q, k, v, seg, seg)):
        assert got.shape == want.shape and torch.equal(got, want)
    want = A.flash_plain(q, k, v, seg, seg, causal=True)
    assert _err(out, want) <= ULP_LIMIT
    assert (out[seg == 0] == 0).all()


def test_flash_causal_planted_faults_fail(dev):
    """At the 3B orig prefill's layout (T = 1664, 1302 valid, GQA 16/2, D =
    128): bounds that cut each live q tile's diagonal kv tile, and the
    straddling q tile 20 (valid and padding rows) forced onto the
    mask-free step, both fail the tolerance; the true call passes."""
    gen = torch.Generator(device=dev).manual_seed(35)
    t, valid = 1664, 1302
    q, k, v, seg = _prefix_inputs(gen, 1, t, 16, 2, 128, [valid])
    want = A.flash_plain(q, k, v, seg, seg, causal=True)
    got = A.flash_varlen_fwd(q, k, v, seg, seg, causal=True)
    assert _err(got, want) <= ULP_LIMIT
    nq = t // 64
    iq = torch.arange(nq, device=dev)
    cut = torch.stack([torch.zeros_like(iq), iq], 1).int()  # [0, iq)
    assert _err(A.flash_varlen_fwd(q, k, v, seg, seg, causal=True,
                                   kv_bounds=cut), want) > ULP_LIMIT
    ts = torch.as_tensor(_tile_seg_np(seg[0].cpu().numpy()), device=dev)
    assert ts[valid // 64] == -1 and (ts[:valid // 64] == 1).all()
    forced = ts.clone()
    forced[valid // 64] = 1
    bad, _ = A._launch_flash("flash_varlen_fwd", q, k, v, seg, seg, True,
                             None, None, None,
                             tile_seg=(forced[None], ts[None]))
    assert _err(bad, want) > ULP_LIMIT


# Gradient of the flash kernel (``attention`` under autograd): the kernel
# forward with the blocked mirror backward against the plain forward with
# the same backward. The gradients are bf16, so the two sides differ by
# their last-bit rounding (one bf16 ulp of the largest |value| is 2^-8 =
# 3.9e-3 of it) and by delta = rowsum(dO * O) taken from two forwards that
# differ by <= ULP_LIMIT ulps per row. A planted fault gives O(1).
GRAD_TOL = 1e-2


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [333, 1024])
def test_flash_gradient_kernel_forward_matches_plain(dev, causal, s):
    """GQA 8/2, B = 2, a padding tail; S = 1,024 takes two 512-key blocks,
    333 the dense fallback. One kernel launch, none in the backward;
    padding rows get zero gradients; both planted faults fail."""
    gen = torch.Generator(device=dev).manual_seed(s + causal)
    q = _rnd(gen, 2, s, 8, 128)
    k, v = _rnd(gen, 2, s, 2, 128), _rnd(gen, 2, s, 2, 128)
    g = _rnd(gen, 2, s, 8, 128)
    seg = (_seg(s, dev) if not causal else
           (torch.arange(s, device=dev) < s - 50).int()[None]).repeat(2, 1)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    f0 = A.FLASH_LAUNCHES
    out = A.attention(*leaves, seg, seg, causal=causal)
    out.backward(g)
    assert A.FLASH_LAUNCHES - f0 == 1
    want_out = A.flash_plain(q, k, v, seg, seg, causal=causal)
    assert _err(out.detach(), want_out) <= ULP_LIMIT
    want = A.flash_backward_plain(q, k, v, seg, seg, causal, None, want_out,
                                  g)
    for got, ref in zip(leaves, want):
        assert _rel(got.grad, ref) <= GRAD_TOL
    assert (leaves[0].grad[seg == 0] == 0).all()
    assert (leaves[1].grad[seg == 0] == 0).all()
    for fault in ("delta_zero", "drop_diag_dk"):
        bad = A.flash_backward_plain(q, k, v, seg, seg, causal, None,
                                     out.detach(), g, fault=fault)
        assert max(_rel(b, w) for b, w in zip(bad, want)) > GRAD_TOL, fault


def test_tiny_train_step_launches_and_freezes(dev):
    """Two tiny selector steps on the card: per step, each sample's ViT
    launches the diag kernel per window layer and the flash kernel per
    full layer, the decoder the flash kernel per layer once for the
    batch; the loss is finite, only the scorer moves."""
    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.models.qwen25vl.weights import init_params
    from visionselector_tpu_torch.train.data import (
        build_train_sample,
        stack_samples,
    )
    from visionselector_tpu_torch.train.loss import to_device
    from visionselector_tpu_torch.train.train_step import (
        ScheduleConfig,
        init_train_state,
        train_step,
    )

    cfg = qwen25vl_tiny()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    rng = np.random.RandomState(0)
    batch = to_device(stack_samples([build_train_sample(
        cfg, (rng.rand(112, 112, 3) * 255).astype(np.uint8), [101], [102],
        [201, 202], budget=0.25, s_bucket=128, t_bucket=64, min_pixels=1,
        max_pixels=10**9) for _ in range(2)]), dev)
    sched = ScheduleConfig(total_steps=2, lr=5e-3)
    state = init_train_state(params, sched)
    frozen = {n: p.detach().clone() for n, p in params.named_parameters()
              if not n.startswith("scorer.")}
    n_full = len(cfg.vision.fullatt_block_indexes)
    for _ in range(2):
        f0, d0 = A.FLASH_LAUNCHES, A.DIAG_LAUNCHES
        state, m = train_step(state, params, batch, cfg, 8, sched)
        torch.cuda.synchronize()
        assert A.DIAG_LAUNCHES - d0 == 2 * (cfg.vision.depth - n_full)
        assert (A.FLASH_LAUNCHES - f0
                == 2 * n_full + cfg.text.num_hidden_layers)
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    for n, p in params.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]) and p.grad is None, n


# LLaVA-OneVision-1.5: K1 at RICE's layout (head dim 64, a CLS row at the
# start of each image segment, S' padded to the 64-row tile), K1 causal and
# K5 at the 8B decoder's GQA 32/8 (n_rep 4), and both at llava_ov_tiny's
# decoder head dim 32.


def _rice_layout(pad_to, grids):
    """seg [1, S'] and bounds of a RICE batch: ``grids`` images' patches in
    a ``pad_to`` bucket, 8 CLS slots, padded to the kernel's tile."""
    from visionselector_tpu_torch.models.llava_ov15.rice import (
        build_rice_batch,
    )

    g = np.asarray(grids)
    px = np.zeros((int((g[:, 0] * g[:, 1] * g[:, 2]).sum()), 588),
                  np.float32)
    rb = build_rice_batch(px, g, pad_to=pad_to, cls_slots=8,
                          tile=A.FLASH_BLOCK)
    return (torch.as_tensor(rb.seg_ids, device="cuda")[None],
            torch.as_tensor(rb.kv_bounds, device="cuda"))


@pytest.mark.parametrize("grids", [[(1, 30, 40)], [(1, 16, 16), (1, 20, 24)],
                                   [(4, 8, 8)]],
                         ids=["one image", "two images", "four frames"])
def test_flash_rice_cls_layout_d64(dev, grids):
    """K1 non-causal at head dim 64 on RICE's CLS'd segments with bounds:
    within ULP_LIMIT of the plain version, padding rows exactly 0; each q
    tile's last kv tile dropped from the bounds fails."""
    seg, bounds = _rice_layout(2048, grids)
    s = seg.shape[1]
    gen = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (_rnd(gen, 1, s, 16, 64) for _ in range(3))
    got = A.flash_varlen_fwd(q, k, v, seg, seg, kv_bounds=bounds)
    want = A.flash_plain(q, k, v, seg, seg, kv_bounds=bounds)
    assert s % 64 == 0 and _err(got, want) <= ULP_LIMIT
    assert (got[:, seg[0] == 0] == 0).all()
    live = (bounds[:, 1] > bounds[:, 0]).int()
    cut = bounds - torch.stack([0 * live, live], 1).int()
    assert _err(A.flash_varlen_fwd(q, k, v, seg, seg, kv_bounds=cut),
                want) > ULP_LIMIT


@pytest.mark.parametrize("d, h, h_kv", [(128, 32, 8), (32, 4, 2)])
@pytest.mark.parametrize("t", [512, 1664])
def test_flash_causal_ov_decoder(dev, d, h, h_kv, t):
    """K1 causal at the OV decoders: GQA 32/8 at head dim 128 (the 8B) and
    4/2 at 32 (the tiny config), ragged valid prefixes."""
    gen = torch.Generator(device=dev).manual_seed(400 + d + t)
    q, k, v, seg = _prefix_inputs(gen, 2, t, h, h_kv, d, [t - 45, t // 3])
    got = A.flash_varlen_fwd(q, k, v, seg, seg, causal=True)
    want = A.flash_plain(q, k, v, seg, seg, causal=True)
    assert _err(got, want) <= ULP_LIMIT
    assert (got[seg == 0] == 0).all()


@pytest.mark.parametrize("d, hq, h_kv", [(128, 32, 8), (32, 4, 2)])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("t_c", [1, 4])
def test_decode_ov_decoder(dev, d, hq, h_kv, quant, t_c):
    """K5 at n_rep 4 (the 8B's 32/8) and at the tiny decoder's head dim
    32, bf16 and int8 pools, lengths at tile edges; the last live tile
    dropped fails."""
    t = 1024
    gen = torch.Generator(device=dev).manual_seed(500 + d + quant + t_c)
    q, k, v, ks, vs = _decode_inputs(gen, 6, t_c, hq, h_kv, t, d, quant)
    base = torch.tensor([0, 63, 64, 65, 437, t - t_c], device=dev)
    got = A.decode_blocked_fwd(q, k, v, base, None, ks, vs)
    want = A.decode_blocked_plain(q, k, v, base, None, ks, vs)
    assert _err(got, want) <= ULP_LIMIT
    tile_cut = torch.div(base, 64, rounding_mode="floor") * 64 - 1
    tile_cut[0] = 0
    assert _err(A.decode_blocked_fwd(q, k, v, tile_cut.clamp(min=0), None,
                                     ks, vs), want) > ULP_LIMIT


def test_tiny_ov_engine_kernels_match_plain_path(dev):
    """llava_ov_tiny on the card (bf16): per prefill one K1 per RICE block
    and one causal K1 per decoder layer, one K5 per layer and decode step;
    the first-token logits within 10% of max |logit| of the plain path."""
    from visionselector_tpu_torch.core.config import llava_ov_tiny
    from visionselector_tpu_torch.models.llava_ov15.model import (
        OVEngine,
        init_ov_params,
    )
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    cfg = llava_ov_tiny()
    params = init_ov_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev, torch.bfloat16)
    rng = np.random.RandomState(0)
    img = (rng.rand(224, 280, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9,
                                temporal_patch_size=1)
    ids = expand_vision_tokens([100, 200], [300, 400], grid)
    for sel in (True, False):
        kern = OVEngine(cfg, params, use_selector=sel, device=dev)
        plain = OVEngine(cfg, params, use_selector=sel, device=dev,
                         attn_impl="plain")
        f0, d0 = A.FLASH_LAUNCHES, A.DECODE_LAUNCHES
        a = kern.generate(ids, px, grid, max_new_tokens=4,
                          eos_token_ids=(-1,))
        assert (A.FLASH_LAUNCHES - f0
                == cfg.vision.depth + cfg.text.num_hidden_layers)
        assert A.DECODE_LAUNCHES - d0 == 3 * cfg.text.num_hidden_layers
        b = plain.generate(ids, px, grid, max_new_tokens=4,
                           eos_token_ids=(-1,))
        assert a.prefill_len == b.prefill_len
        assert torch.isfinite(a.logits).all()
        scale = b.logits.abs().max().item()
        assert (a.logits - b.logits).abs().max().item() <= 0.1 * scale


@pytest.mark.parametrize("tied", [True, False])
def test_lm_head_makes_no_fp32_weight_copy(dev, tied):
    """The head on CUDA tensors without a gradient: within ULP_LIMIT bf16
    ulps of the upcast path (fp32 operands), fp32 logits, and one call
    allocates less than half the weight's fp32 copy (only its output); a
    1-D row (a decode step) too. With a gradient to carry it keeps the
    upcast and differentiates."""
    import dataclasses

    from visionselector_tpu_torch.core.config import llava_ov_tiny
    from visionselector_tpu_torch.models.qwen25vl import lm as tlm

    cfg = dataclasses.replace(
        llava_ov_tiny().text, hidden_size=1024, vocab_size=151936,
        num_hidden_layers=1, tie_word_embeddings=tied)
    lm = tlm.LanguageModel(cfg, dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for p in lm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
    w = lm.embed_tokens.t() if tied else lm.lm_head_kernel
    h = _rnd(gen, 16, 1024)
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = tlm.lm_head(lm, h)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        want = h.float() @ w.float()
        row = tlm.lm_head(lm, h[3])
    assert got.dtype == torch.float32 and got.shape == (16, 151936)
    assert _err(got, want) <= ULP_LIMIT
    assert _err(row[None], want[3:4]) <= ULP_LIMIT
    assert extra < w.numel() * 4 // 2, extra
    hg = h.clone().requires_grad_(True)
    tlm.lm_head(lm, hg).sum().backward()
    torch.testing.assert_close(hg.grad.float(), w.float().sum(1).expand(
        16, -1), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b, hq, h_kv", [(8, 16, 2), (1, 16, 2), (4, 32, 8)])
def test_decode_verify_chunk_t_c8(dev, quant, b, hq, h_kv):
    """K5 at t_c = 8, a speculative verify chunk of m = 7 proposals: 8
    slots and one of the 3B's widths and 4 at OV-8B's (n_rep 4), bf16 and
    int8, bases at tile edges; the in-chunk causal limit off by one (the
    kernel given base + 1) fails."""
    t, t_c = 2048, 8
    gen = torch.Generator(device=dev).manual_seed(800 + b + hq + quant)
    q, k, v, ks, vs = _decode_inputs(gen, b, t_c, hq, h_kv, t, 128, quant)
    base = _decode_bases(b, t - 1, t_c, dev)
    got = A.decode_blocked_fwd(q, k, v, base, None, ks, vs)
    want = A.decode_blocked_plain(q, k, v, base, None, ks, vs)
    assert _err(got, want) <= ULP_LIMIT
    assert _err(A.decode_blocked_fwd(q, k, v, base + 1, None, ks, vs),
                want) > ULP_LIMIT


def test_int4_route_on_the_card(dev):
    """A packed int4 cache on the card takes the plain int4 route (no K5
    launch, counted), equal to the plain decode of its unpacked values;
    the decode kernel raises on it."""
    from visionselector_tpu_torch.models.qwen25vl.lm import (
        pack_int4,
        quantize_kv,
    )

    gen = torch.Generator(device=dev).manual_seed(41)
    q = _rnd(gen, 8, 4, 16, 128)
    kv = _rnd(gen, 2, 8, 2048, 2, 128)
    (k4, ks), (v4, vs) = quantize_kv(kv[0], 4), quantize_kv(kv[1], 4)
    base = torch.tensor([0, 63, 64, 65, 300, 1302, 1900, 2040], device=dev)
    n0, i0 = A.DECODE_LAUNCHES, A.INT4_DECODE_CALLS
    got = A.chunk_decode_attention(q, pack_int4(k4), pack_int4(v4), base,
                                   k_scale=ks, v_scale=vs)
    assert (A.DECODE_LAUNCHES - n0, A.INT4_DECODE_CALLS - i0) == (0, 1)
    want = A.decode_blocked_plain(q, k4, v4, base, None, ks, vs)
    assert _err(got, want) <= ULP_LIMIT
    with pytest.raises(ValueError, match="int4"):
        A.decode_blocked_fwd(q, pack_int4(k4), pack_int4(v4), base, None,
                             ks, vs)


@pytest.mark.parametrize("kv_quant", [None, "int4"])
def test_tiny_speculative_batcher_on_the_card(dev, kv_quant):
    """Speculative slots (m = 3) on the card: each round launches K5 once
    per layer at t_c 4 on a bf16 pool and never on an int4 one (the plain
    route, counted per layer and round); budgets kept, one-shot's first
    tokens."""
    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
    )
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.models.qwen25vl.weights import init_params

    cfg = qwen25vl_tiny()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    eng = QwenVLEngine(cfg, params, device=dev)
    n0 = A.DECODE_LAUNCHES_BY_ROWS.get(4, 0)
    bat = ContinuousBatcher(eng, n_slots=2, t_max=256, chunk=4,
                            kv_quant=kv_quant, speculative=3)
    reqs = [dict(input_ids=np.arange(5, 5 + n)) for n in (7, 20)]
    try:
        res = [bat.submit(r, 9, (-1,)) for r in reqs]
    finally:
        bat.shutdown()
    rounds = bat.stats["spec_steps"]
    layers = cfg.text.num_hidden_layers
    k5 = A.DECODE_LAUNCHES_BY_ROWS.get(4, 0) - n0
    if kv_quant is None:
        assert k5 == layers * rounds
    else:
        assert k5 == 0
        assert bat.stats["int4_plain_decode_calls"] == layers * rounds
    for r, req in zip(res, reqs):
        assert len(r.tokens) == 9
        assert r.tokens[0] == eng.generate(**req, max_new_tokens=1).tokens[0]


def _packed_row_seg(t, n_seg, length, dev):
    """A packed LM row: ``n_seg`` samples of ``length`` rows, segment ids
    1..n_seg, then a padding tail."""
    seg = torch.zeros(t, dtype=torch.int32, device=dev)
    for i in range(n_seg):
        seg[i * length:(i + 1) * length] = i + 1
    return seg


@pytest.mark.parametrize("t, length", [(2048, 330), (333, 70)])
def test_flash_causal_packed_row_matches_plain(dev, t, length):
    """K1 causal on packed rows (several samples, each its own segment,
    tiles straddling them; GQA 16/2, D = 128, B = 2): the forward within
    ULP_LIMIT of ``flash_plain``, padding rows zero; the kernel given the
    row's segments merged into one (a planted fault) exceeds it; dq, dk,
    dv through ``FlashAttentionFn`` within GRAD_TOL of autograd of the
    plain version, counted as one launch under grad."""
    gen = torch.Generator(device=dev).manual_seed(t)
    b = 2
    q, g = _rnd(gen, b, t, 16, 128), _rnd(gen, b, t, 16, 128)
    k, v = _rnd(gen, b, t, 2, 128), _rnd(gen, b, t, 2, 128)
    n_seg = min(4, t // length)
    seg = _packed_row_seg(t, n_seg, length, dev)[None].repeat(b, 1)
    got = A.flash_varlen_fwd(q, k, v, seg, seg, causal=True)
    want = A.flash_plain(q, k, v, seg, seg, causal=True)
    assert _err(got, want) <= ULP_LIMIT
    assert (got[seg == 0] == 0).all()
    merged = (seg > 0).int()
    assert _err(A.flash_varlen_fwd(q, k, v, merged, merged, causal=True),
                want) > ULP_LIMIT
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n0 = A.FLASH_GRAD_LAUNCHES
    A.attention(*leaves, seg, seg, causal=True).backward(g)
    assert A.FLASH_GRAD_LAUNCHES - n0 == 1
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    A.flash_plain(*refs, seg, seg, causal=True).backward(g)
    for got_g, ref in zip(leaves, refs):
        assert _rel(got_g.grad, ref.grad) <= GRAD_TOL


@pytest.mark.parametrize("s, h, d", [(256, 4, 80), (6144, 16, 80)])
def test_diag_gradient_matches_plain_autograd(dev, s, h, d):
    """``attention_diag`` with inputs that require grad goes through
    ``FlashAttentionFn``: the diag kernel forward (one launch, counted in
    DIAG_GRAD_LAUNCHES), the mirror backward; dq, dk, dv within GRAD_TOL
    of autograd of ``diag_plain``; padding rows get zero gradients; the
    mirror given one merged segment (a planted fault) exceeds it. Without
    grad nothing goes through the Function."""
    gen = torch.Generator(device=dev).manual_seed(s)
    q, k, v, g = (_rnd(gen, 1, s, h, d) for _ in range(4))
    seg_np = np.zeros(s, np.int32)
    for w in range(s // 64):  # windows of 48 rows, each in its own tile
        seg_np[w * 64:w * 64 + 48] = w + 1
    seg = torch.as_tensor(seg_np, device=dev)[None]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n0, d0 = A.DIAG_GRAD_LAUNCHES, A.DIAG_LAUNCHES
    out = A.attention_diag(*leaves, seg)
    assert out.grad_fn is not None
    out.backward(g)
    assert A.DIAG_GRAD_LAUNCHES - n0 == 1 and A.DIAG_LAUNCHES - d0 == 1
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = A.diag_plain(*refs, seg)
    want.backward(g)
    assert _err(out.detach(), want.detach()) <= ULP_LIMIT
    for got, ref in zip(leaves, refs):
        assert _rel(got.grad, ref.grad) <= GRAD_TOL
    assert (leaves[0].grad[seg == 0] == 0).all()
    merged = (seg > 0).int()
    bad = A.flash_backward_plain(q, k, v, merged, merged, False, None,
                                 out.detach(), g)
    assert max(_rel(x, r.grad) for x, r in zip(bad, refs)) > GRAD_TOL
    with torch.no_grad():
        assert A.attention_diag(*leaves, seg).grad_fn is None
    assert A.DIAG_GRAD_LAUNCHES - n0 == 1


def test_fused_vit_attention_raises_under_grad(dev):
    """The fused kernel has no backward: with a qkv slab that requires
    grad it raises instead of returning an output cut from the graph; the
    plain route stays differentiable."""
    from visionselector_tpu_torch.kernels import fused_vit_attn as FV

    gen = torch.Generator(device=dev).manual_seed(0)
    s, h, d = 128, 4, 80
    qkv = _rnd(gen, s, 3 * h * d).requires_grad_(True)
    seg = torch.ones(s, dtype=torch.int32, device=dev)
    cos = torch.ones(s, d, device=dev)
    sin = torch.zeros(s, d, device=dev)
    n0 = FV.FUSED_LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        FV.fused_vit_attention(qkv, seg, cos, sin, None, h, d)
    assert FV.FUSED_LAUNCHES == n0
    out = FV.fused_vit_attention(qkv, seg, cos, sin, None, h, d,
                                 impl="plain")
    assert out.grad_fn is not None


# DPO and GRPO on the tiny config: the kernel path against
# attn_impl="plain", each gradient within TRAIN_GRAD_TOL of its largest
# |value| (chip_smoke.py's rule for bf16 training gradients).
TRAIN_GRAD_TOL = 0.15


def _tiny_bf16(dev, seed=0):
    from visionselector_tpu_torch.core.config import qwen25vl_tiny
    from visionselector_tpu_torch.models.qwen25vl.weights import init_params

    cfg = qwen25vl_tiny()
    return cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev, torch.bfloat16)


def _leaf_grad(params, name, loss):
    (g,) = torch.autograd.grad(loss, [dict(params.named_parameters())[name]])
    return g


def test_tiny_dpo_step_matches_plain(dev):
    """One DPO pair on the card at the starting weights: the loss is ln 2
    with a zero margin on the kernel path (policy and reference the same
    computation); the gradient of a decoder kernel within TRAIN_GRAD_TOL
    of the ``attn_impl="plain"`` run's; the decoder's K1 launches with
    grad are one per layer per forward (chosen and rejected), and one
    ``dpo_train_step`` moves the decoder and leaves the reference."""
    from visionselector_tpu_torch.train.data import (
        build_train_sample,
        stack_samples,
    )
    from visionselector_tpu_torch.train.dpo import (
        DPOScheduleConfig,
        ReferencePolicy,
        dpo_pair_loss,
        dpo_train_step,
        init_dpo_state,
    )
    from visionselector_tpu_torch.train.loss import to_device

    cfg, params = _tiny_bf16(dev)
    img = (np.random.RandomState(0).rand(112, 112, 3) * 255).astype(np.uint8)
    kw = dict(budget=0.25, s_bucket=128, t_bucket=64, min_pixels=1,
              max_pixels=10**9)
    chosen, rejected = (to_device(stack_samples([build_train_sample(
        cfg, img, [101], [102], ans, **kw)]), dev)
        for ans in ([201, 202, 203], [301, 302]))
    sched = DPOScheduleConfig(total_steps=3, lr=5e-3)
    state = init_dpo_state(params, sched)
    ref = ReferencePolicy(params, state)
    name = "lm.layers.1.q_kernel"
    n0 = A.FLASH_GRAD_LAUNCHES
    loss, m = dpo_pair_loss(params, ref, chosen, rejected, sched)
    assert A.FLASH_GRAD_LAUNCHES - n0 == 2 * cfg.text.num_hidden_layers
    assert float(m["reward_margin"]) == 0.0
    assert float(loss) == float(-torch.nn.functional.logsigmoid(
        torch.zeros(())))
    got = _leaf_grad(params, name, loss)
    plain, _ = dpo_pair_loss(params, ref, chosen, rejected, sched,
                             attn_impl="plain")
    assert _rel(got, _leaf_grad(params, name, plain)) <= TRAIN_GRAD_TOL
    start = {n: w.clone() for n, w in ref.weights.items()}
    for _ in range(2):  # the first update has lr 0
        state, m = dpo_train_step(state, ref, params, chosen, rejected, cfg,
                                  sched)
    assert torch.isfinite(m["loss"])
    assert all(torch.equal(ref.weights[n], start[n]) for n in start)
    assert not torch.equal(dict(params.named_parameters())[name],
                           start[name])


def test_tiny_grpo_rollout_and_step_matches_plain(dev):
    """GRPO with fresh LoRA adapters on the card (B = 0: the policy is the
    reference, the base with the adapters off): 2 rollouts of 6 tokens
    through the engine with the adapters live (K5 per decode step and
    layer), each reproduced by one-shot ``generate`` with its seed; at
    step 0 the KL is exactly 0 and clip_ratio 0 on the kernel path; an
    adapter B's gradient within TRAIN_GRAD_TOL of the
    ``attn_impl="plain"`` run's."""
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import (
        expand_vision_tokens_at_slots,
    )
    from visionselector_tpu_torch.train.data import stack_samples
    from visionselector_tpu_torch.train.dpo import ReferencePolicy
    from visionselector_tpu_torch.train.grpo import (
        GRPOScheduleConfig,
        build_grpo_sample,
        grpo_loss,
        init_grpo_state,
        rollout_group,
    )
    from visionselector_tpu_torch.train.lora import add_lora_params
    from visionselector_tpu_torch.train.loss import to_device

    cfg, params = _tiny_bf16(dev, seed=1)
    add_lora_params(params.lm, torch.Generator(device=dev).manual_seed(2),
                    rank=4, alpha=8)
    img = (np.random.RandomState(1).rand(84, 112, 3) * 255).astype(np.uint8)
    mm = dict(min_pixels=1, max_pixels=10**9)
    px, grid = preprocess_image(img, **mm)
    raw, slots = [101, 102, 103], [2]
    ids = expand_vision_tokens_at_slots(raw, slots, grid)
    sched = GRPOScheduleConfig(num_generations=2, max_completion_length=6,
                               lora_rank=4, total_steps=2)
    engine = QwenVLEngine(cfg, params, use_selector=False, device=dev)
    k0 = A.DECODE_LAUNCHES
    comps = rollout_group(engine, ids, px, grid, sched, seed=5,
                          eos_token_ids=(-1,))
    assert A.DECODE_LAUNCHES - k0 == 2 * 5 * cfg.text.num_hidden_layers
    for g, c in enumerate(comps):
        assert engine.generate(ids, px, grid, max_new_tokens=6,
                               temperature=1.0, seed=5 * 1000003 + g,
                               eos_token_ids=(-1,)).tokens == c.tolist()
    batch = to_device(stack_samples([build_grpo_sample(
        cfg, [img], raw, slots, c, budget=0.25, s_bucket=128, t_bucket=64,
        **mm) for c in comps]), dev)
    state = init_grpo_state(params, sched)
    ref = ReferencePolicy(params, state)
    adv = torch.tensor([1.0, -1.0], device=dev)
    loss, m = grpo_loss(params, ref, batch, adv, sched)
    assert float(m["kl"]) == 0.0 and float(m["clip_ratio"]) == 0.0
    name = "lm.layers.0.q_kernel_lora_b"
    got = _leaf_grad(params, name, loss)
    plain, _ = grpo_loss(params, ref, batch, adv, sched, attn_impl="plain")
    assert _rel(got, _leaf_grad(params, name, plain)) <= TRAIN_GRAD_TOL


# The weight-only quantized product (kernels/wq_matmul.py): the kernel
# against wq_matmul_plain on the same bf16 inputs, ULP_LIMIT bf16 ulps of
# each row's largest |value| (fp32 sums in another order, rounded once).
WQ_SPECS = {"int8": (8, 0), "int4": (4, 0), "int4:g128": (4, 128)}


def _wq_weight(dev, spec, k, n, seed):
    from visionselector_tpu_torch.models.qwen25vl.lm import pack_int4

    bits, group = WQ_SPECS[spec]
    qmax = 127 if bits == 8 else 7
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-qmax, qmax + 1, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((k // group, n) if group else (n,), generator=gen,
                   device=dev) * 2e-3 + 1e-4
    return (pack_int4(q) if bits == 4 else q), s


@pytest.mark.parametrize("rows", [1, 8, 16, 32])
@pytest.mark.parametrize("spec", list(WQ_SPECS))
def test_wq_matmul_matches_plain(dev, spec, rows):
    """K = 1,152 (four and a half 256-row chunks); N = 560, a partial last
    column tile (and, packed, 280-byte rows that take the byte loads)."""
    from visionselector_tpu_torch.kernels import wq_matmul as wq

    w, s = _wq_weight(dev, spec, 1152, 560, rows)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = _rnd(gen, rows, 1152)
    n0 = wq.WQ_LAUNCHES
    got = wq.wq_matmul(x, w, s)
    assert wq.WQ_LAUNCHES == n0 + 1
    assert _err(got, wq.wq_matmul_plain(x, w, s)) <= ULP_LIMIT
    with pytest.raises(ValueError):
        wq.wq_matmul(x.float(), w, s)


def test_wq_launches_on_decode_and_dequantize_on_prefill(dev):
    """A quantized tiny decoder on the card: every decode step's seven
    products per layer launch the kernel, each prefill's take the
    dequantize route; the first token equals the plain routes'."""
    from visionselector_tpu_torch.kernels import wq_matmul as wq
    from visionselector_tpu_torch.models.qwen25vl.lm import (
        apply_weight_quantization,
    )
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    cfg, params = _tiny_bf16(dev, seed=3)
    apply_weight_quantization(params, "int4:g32")
    # 67 prefill rows: more than int4's row cap (WQ_MAX_ROWS)
    img = (np.random.RandomState(2).rand(224, 224, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens([100], [200, 300], grid)
    assert len(ids) > wq.WQ_MAX_ROWS[torch.uint8]
    eng = QwenVLEngine(cfg, params, device=dev)
    n_layers = cfg.text.num_hidden_layers
    w0, d0, k0 = wq.WQ_LAUNCHES, wq.WQ_DEQUANT_CALLS, A.DECODE_LAUNCHES
    got = eng.generate(ids, px, grid, max_new_tokens=5, eos_token_ids=(-1,))
    steps = (A.DECODE_LAUNCHES - k0) // n_layers
    assert steps == 4
    assert wq.WQ_LAUNCHES - w0 == 7 * n_layers * steps
    assert wq.WQ_DEQUANT_CALLS - d0 == 7 * n_layers
    old = wq.WQ_MAX_ROWS
    try:
        wq.WQ_MAX_ROWS = {}
        plain = QwenVLEngine(cfg, params, device=dev, attn_impl="plain")
        want = plain.generate(ids, px, grid, max_new_tokens=1)
    finally:
        wq.WQ_MAX_ROWS = old
    assert got.tokens[0] == want.tokens[0]


def test_lora_gradient_through_a_quantized_layer(dev):
    """LoRA adapters over an int8 decoder on the card: an adapter B's
    gradient through eight rows of prefill (the kernel forward where a
    product's input carries no gradient, the dequantize route where it
    does) within TRAIN_GRAD_TOL of plain autograd through the dequantize
    route alone (an empty ``WQ_MAX_ROWS``)."""
    from visionselector_tpu_torch.kernels import wq_matmul as wq
    from visionselector_tpu_torch.models.qwen25vl import lm as L
    from visionselector_tpu_torch.train.lora import add_lora_params

    cfg, params = _tiny_bf16(dev, seed=4)
    lm = L.apply_weight_quantization(params, "int8").lm
    add_lora_params(lm, torch.Generator(device=dev).manual_seed(5), rank=4,
                    alpha=8)
    with torch.no_grad():
        for layer in lm.layers:
            for name in L.QUANT_KERNELS:
                getattr(layer, name + "_lora_b").normal_(0.0, 0.05)
    b = lm.layers[0].down_kernel_lora_b
    b.requires_grad_(True)
    t = 8
    proj = torch.randn(1, t, cfg.text.hidden_size, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(6))

    def grad():
        ids = torch.arange(3, 3 + t, device=dev)
        h, _ = L.lm_prefill(lm, L.embed_tokens(lm, ids)[None],
                            torch.arange(t, device=dev).expand(3, 1, t),
                            torch.ones(1, t, dtype=torch.int32, device=dev))
        (g,) = torch.autograd.grad((h.float() * proj).sum(), [b])
        return g

    w0, d0 = wq.WQ_LAUNCHES, wq.WQ_DEQUANT_CALLS
    got = grad()
    assert wq.WQ_LAUNCHES > w0 and wq.WQ_DEQUANT_CALLS > d0
    old = wq.WQ_MAX_ROWS
    try:
        wq.WQ_MAX_ROWS = {}
        w0 = wq.WQ_LAUNCHES
        want = grad()
        assert wq.WQ_LAUNCHES == w0
    finally:
        wq.WQ_MAX_ROWS = old
    assert float(want.abs().max()) > 0
    assert _rel(got, want) <= TRAIN_GRAD_TOL
