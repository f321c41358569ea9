"""The port's int4 slot pool (``lm.QuantKVCache`` packed two values a
byte, ``attention.decode_int4_plain``, ``ContinuousBatcher(kv_quant=
"int4")``) against the JAX package's int4 ``QuantKVCache`` on
qwen25vl_tiny (fp32): the 4-bit rule's values and scales (elements whose
x / s lies within fp32 noise of a half-integer counted, not excused by a
looser check), the packed layout, the pool's bytes at the 3B's widths,
decode steps within 1e-4 of JAX's over the same int4 values, the counted
plain route, the decode kernel refusing a packed cache, and the batcher."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_serving_params import (  # noqa: F401 (one_thread: autouse)
    EOS,
    one_thread,
    serving_engines,
)

from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu_torch.core.config import qwen25vl_3b
from visionselector_tpu_torch.kernels import attention as A
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl.continuous import (
    ContinuousBatcher,
)


@pytest.fixture(scope="module")
def w():
    return serving_engines()


def test_quantize_int4_matches_jax():
    """Values and scales equal JAX's ``quantize_kv(x, jnp.int4)``: scales
    bit for bit, values everywhere but where x / s lies within 1e-6 of a
    half-integer (counted; none of these seeded rows has one). Exact
    halves round to even, as ``jnp.round``."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 64, 24) * rng.rand(2, 3, 64, 1) * 5).astype(
        np.float32)
    x[0, 0, 0] = [7.0, 2.5, 3.5, -0.5, -1.5, 0.5] + [0.0] * 18  # s = 1
    jq, js = jlm.quantize_kv(jnp.asarray(x), jnp.int4)
    tq, ts = tlm.quantize_kv(torch.from_numpy(x), 4)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = np.asarray(jq.astype(jnp.int8))
    ratio = x / np.asarray(js)[..., None]
    near = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-6
    near[0, 0, 0, :6] = False  # the exact halves must agree
    off = tq.numpy() != want
    assert not (off & ~near).any(), int((off & ~near).sum())
    assert tq[0, 0, 0, :6].tolist() == [7, 2, 4, -0, -2, 0]
    assert int(tq.abs().max()) == 7


def test_pack_unpack_round_trip_and_layout():
    vals = torch.arange(-8, 8, dtype=torch.int8)
    pairs = torch.cartesian_prod(vals, vals).reshape(16, 32)  # every pair
    packed = tlm.pack_int4(pairs)
    assert packed.dtype == torch.uint8 and packed.shape == (16, 16)
    assert torch.equal(tlm.unpack_int4(packed), pairs)
    # element 2j in the low nibble, 2j + 1 in the high one, two's complement
    assert tlm.pack_int4(torch.tensor([1, -2], dtype=torch.int8)).item() \
        == 0xE1
    with pytest.raises(ValueError, match="odd"):
        tlm.pack_int4(torch.zeros(3, dtype=torch.int8))


def test_pool_bytes_at_the_3b_widths():
    """8 slots x 2,048 rows of the 3B decoder (36 layers, 2 kv heads, head
    dim 128), on the meta device (no memory): int4 values 150,994,944
    bytes + 9,437,184 of scales, against 603,979,776 for bf16."""
    cfg = qwen25vl_3b().text

    def nbytes(cache):
        fields = ("k", "v", "k_scale", "v_scale")
        return [getattr(cache, f).numel() * getattr(cache, f).element_size()
                for f in fields if hasattr(cache, f)]

    int4 = tlm.init_kv_cache(cfg, 8, 2048, "meta", torch.bfloat16,
                             quant="int4")
    bf16 = tlm.init_kv_cache(cfg, 8, 2048, "meta", torch.bfloat16)
    assert int4.k.shape[-1] == 64 and int4.packed
    b4 = nbytes(int4)
    assert sum(b4[:2]) == 150_994_944 and sum(b4[2:]) == 9_437_184
    assert sum(nbytes(bf16)) == 603_979_776
    assert abs(sum(b4) / 603_979_776 - 0.2656) < 1e-3


@pytest.mark.parametrize("t_c", [1, 4])
def test_int4_decode_matches_jax(w, t_c):
    """A decode step (t_c 1) and a verify-sized chunk (t_c 4) over an int4
    cache holding the prefill's k/v: logits within 1e-4 of JAX's over its
    int4 ``QuantKVCache`` of the same values, lengths + t_c, the new rows
    written packed with their scales, and the first row's logits within
    the reference's 0.25 drift bound of the full-precision cache's."""
    jeng, teng = w["jsel"], w["tsel"]
    req = dict(input_ids=w["ids_for"]([8, 9]), pixel_values=w["px"],
               grid_thw=w["grid"])
    js = jeng.generate(**req, max_new_tokens=8, eos_token_ids=EOS,
                       _defer_decode=True)
    k4, ks = jlm.quantize_kv(js.cache.k, jnp.int4)
    v4, vs = jlm.quantize_kv(js.cache.v, jnp.int4)
    jc = jlm.QuantKVCache(k=k4, v=v4, k_scale=ks, v_scale=vs,
                          length=js.cache.length)
    tc = tlm.QuantKVCache(
        k=tlm.pack_int4(torch.from_numpy(np.array(k4.astype(jnp.int8)))),
        v=tlm.pack_int4(torch.from_numpy(np.array(v4.astype(jnp.int8)))),
        k_scale=torch.from_numpy(np.array(ks)),
        v_scale=torch.from_numpy(np.array(vs)),
        length=torch.from_numpy(np.array(js.cache.length)).long())
    fp = tlm.KVCache(*(torch.from_numpy(np.array(x)) for x in (
        js.cache.k, js.cache.v)), length=tc.length.clone())
    ids = np.asarray([js.next_token] + [11, 12, 13][:t_c - 1], np.int64)
    pos = js.start_pos + np.arange(t_c)
    jemb = jlm.embed_tokens(jeng.params["lm"], jnp.asarray(ids))[None]
    jpos = jnp.broadcast_to(jnp.asarray(pos)[None, None], (3, 1, t_c))
    jh, jc2 = jlm.lm_decode_chunk(jeng.params["lm"], jc, jemb, jpos,
                                  jeng.cfg.text)
    jl = np.asarray(jlm.lm_head(jeng.params["lm"], jh[0], jeng.cfg.text))
    calls = A.INT4_DECODE_CALLS
    temb = tlm.embed_tokens(teng.params.lm, torch.from_numpy(ids))[None]
    tpos = torch.from_numpy(pos).expand(3, 1, t_c)
    step = tlm.lm_decode_step if t_c == 1 else tlm.lm_decode_chunk
    th, tc2 = step(teng.params.lm, tc, temb, tpos)
    tl = tlm.lm_head(teng.params.lm, th[0]).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    n_layers = teng.cfg.text.num_hidden_layers
    assert A.INT4_DECODE_CALLS - calls == n_layers
    np.testing.assert_array_equal(tc2.length.numpy(), np.asarray(jc2.length))
    base = int(js.cache.length[0, 0])
    got = tlm.unpack_int4(tc2.k[:, 0, base:base + t_c])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jc2.k[:, 0, base:base + t_c]).astype(np.int8))
    np.testing.assert_allclose(tc2.k_scale[:, 0, base:base + t_c].numpy(),
                               np.asarray(jc2.k_scale[:, 0, base:base + t_c]),
                               rtol=1e-5)
    fh, _ = step(teng.params.lm, fp, temb, tpos)
    fl = tlm.lm_head(teng.params.lm, fh[0]).numpy()
    # the reference's bound is for a decode step: the chunk's first row
    assert np.abs(fl[0] - tl[0]).max() / np.abs(fl[0]).max() < 0.25


def test_int4_route_is_counted_and_the_kernel_refuses_it():
    """``chunk_decode_attention`` on packed caches takes the int4 route
    under either impl and counts it, equal to the kernel's plain version
    on the unpacked values; ``decode_blocked_fwd`` raises on a packed
    cache rather than misread it."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 2, 8, 24, generator=g)
    q8 = torch.randint(-7, 8, (2, 3, 70, 2, 24), generator=g,
                       dtype=torch.int8)
    s = torch.rand(2, 3, 70, 2, generator=g) * 0.1
    k4, v4 = tlm.pack_int4(q8[0]), tlm.pack_int4(q8[1])
    base = torch.tensor([0, 33, 68])
    calls = A.INT4_DECODE_CALLS
    want = A.decode_blocked_plain(q, q8[0], q8[1], base, None, s[0], s[1])
    for impl in (None, "plain"):
        got = A.chunk_decode_attention(q, k4, v4, base, k_scale=s[0],
                                       v_scale=s[1], impl=impl)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert A.INT4_DECODE_CALLS - calls == 2
    with pytest.raises(ValueError, match="int4"):
        A.decode_blocked_fwd(q, k4, v4, base, None, s[0], s[1])
    with pytest.raises(ValueError, match="scales"):
        A.decode_int4_plain(q, k4, v4, base)


@pytest.mark.parametrize("speculative", [0, 3])
def test_int4_batcher_is_deterministic(w, speculative):
    """An int4 pool serves image and text requests to their budgets, the
    same tokens in two runs, the first token one-shot's (the prefill's),
    every decode attention on the plain int4 route (counted per layer and
    step or round), the pool's values packed."""
    eng = w["tsel"]
    reqs = [(dict(input_ids=w["ids_for"]([8, 9]), pixel_values=w["px"],
                  grid_thw=w["grid"]), 9),
            (dict(input_ids=np.asarray([7, 8, 9, 10], np.int64)), 6)]
    runs = []
    for _ in range(2):
        bat = ContinuousBatcher(eng, n_slots=2, t_max=128, chunk=4,
                                kv_quant="int4", speculative=speculative)
        try:
            runs.append([bat.submit(r, m, EOS).tokens for r, m in reqs])
            assert bat.pool.k.dtype == torch.uint8
            assert bat.pool.k.shape[-1] == eng.cfg.text.head_dim // 2
            steps = bat.stats["chunks"] * bat.chunk
            assert bat.stats["int4_plain_decode_calls"] == \
                eng.cfg.text.num_hidden_layers * steps
        finally:
            bat.shutdown()
    assert runs[0] == runs[1]
    assert [len(t) for t in runs[0]] == [9, 6]
    for (r, _), toks in zip(reqs, runs[0]):
        assert toks[0] == eng.generate(**r, max_new_tokens=1,
                                       eos_token_ids=EOS).tokens[0]
