"""The port's decode attention and int8 KV cache against the JAX package's:
``decode_blocked_plain`` (the plain version of the decode kernel) against
the Pallas kernel ``_decode_blocked_pallas`` run in interpret mode and
against the reference's XLA ``decode_attention`` / ``chunk_decode_attention``;
the port's dense ``impl="plain"`` path against the same; ``quantize_kv``;
and one ``lm_decode_step`` over an int8 cache. Same numpy inputs into both;
fp32, atol 1e-5 for attention (sum-order differences between a dense
softmax and the kernel's online one) and 1e-4 through the decoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.kernels import attention as jattn
from visionselector_tpu.models.qwen25vl import lm as jlm
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.kernels import attention as tattn
from visionselector_tpu_torch.models.qwen25vl import lm as tlm
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params

ATOL = 1e-5
B, T, HQ, HKV, D = 4, 256, 16, 2, 64  # GQA n_rep 8, four 64-key tiles
# Base lengths at tile edges (t_c = 1 attends < base + 1; t_c = 4 crosses
# into the next tile from 61 and 124).
BASES = {1: [0, 63, 64, 191], 4: [0, 61, 124, 252]}


def _inputs(seed, t_c, quant):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, t_c, HQ, D).astype(np.float32)
    if quant:
        k = rng.randint(-127, 128, (B, T, HKV, D)).astype(np.int8)
        v = rng.randint(-127, 128, (B, T, HKV, D)).astype(np.int8)
        ks = (rng.rand(B, T, HKV) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(B, T, HKV) * 0.02 + 1e-3).astype(np.float32)
    else:
        k = rng.randn(B, T, HKV, D).astype(np.float32)
        v = rng.randn(B, T, HKV, D).astype(np.float32)
        ks = vs = None
    base = np.asarray(BASES[t_c], np.int32)
    return q, k, v, ks, vs, base


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("t_c", [1, 4])
def test_blocked_plain_matches_pallas_interpret(t_c, quant):
    q, k, v, ks, vs, base = _inputs(t_c + 2 * quant, t_c, quant)
    want = jattn._decode_blocked_pallas(
        _j(q), _j(k), _j(v), _j(base), D**-0.5, 64, interpret=True,
        k_scale=_j(ks), v_scale=_j(vs))
    got = tattn.decode_blocked_plain(_t(q), _t(k), _t(v),
                                     _t(base.astype(np.int64)), None,
                                     _t(ks), _t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("impl", [None, "plain"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("t_c", [1, 4])
def test_decode_attention_matches_xla(t_c, quant, impl):
    """Both port paths (the kernel's plain version, the default on CPU
    tensors, and the dense plain path) against the reference's XLA
    decode."""
    q, k, v, ks, vs, base = _inputs(10 + t_c + 2 * quant, t_c, quant)
    if t_c == 1:
        want = jattn.decode_attention(
            _j(q), _j(k), _j(v), _j(base + 1), k_scale=_j(ks),
            v_scale=_j(vs), impl="xla")
        got = tattn.decode_attention(
            _t(q), _t(k), _t(v), _t(base.astype(np.int64) + 1),
            k_scale=_t(ks), v_scale=_t(vs), impl=impl)
    else:
        want = jattn.chunk_decode_attention(
            _j(q), _j(k), _j(v), _j(base), k_scale=_j(ks), v_scale=_j(vs),
            impl="xla")
        got = tattn.chunk_decode_attention(
            _t(q), _t(k), _t(v), _t(base.astype(np.int64)), k_scale=_t(ks),
            v_scale=_t(vs), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_blocked_plain_masks_and_zero_rows():
    """A slot with no valid key (base -1 at t_c = 1) gives exact zeros, and
    keys past each row's limit do not matter."""
    q, k, v, _, _, _ = _inputs(7, 1, False)
    base = torch.tensor([-1, 0, 100, 255])
    out = tattn.decode_blocked_plain(_t(q), _t(k), _t(v), base)
    assert (out[0] == 0).all() and out[1:].abs().amax() > 0
    k2, v2 = k.copy(), v.copy()
    k2[2, 101:], v2[2, 101:] = 1e3, -1e3
    out2 = tattn.decode_blocked_plain(_t(q), _t(k2), _t(v2), base)
    assert torch.equal(out[2], out2[2])


def test_cpu_decode_launches_no_kernel():
    q, k, v, ks, vs, base = _inputs(8, 1, True)
    n0 = tattn.DECODE_LAUNCHES
    tattn.decode_blocked_fwd(_t(q), _t(k), _t(v), _t(base), None, _t(ks),
                             _t(vs))
    assert tattn.DECODE_LAUNCHES == n0
    with pytest.raises(ValueError, match="impl"):
        tattn.decode_attention(_t(q), _t(k), _t(v), _t(base), impl="xla")


def test_quantize_kv_matches_jax():
    x = np.random.RandomState(3).randn(2, 5, 7, 2, 24).astype(np.float32)
    x[0, 0, 0, 0] = 0.0  # an all-zero row: scale 1e-12, values 0
    jq, js = jlm.quantize_kv(jnp.asarray(x))
    tq, ts = tlm.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tlm.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jlm.dequantize_kv(jq, js, jnp.float32)))


def test_decode_step_int8_cache_matches_jax():
    """One decode step over an int8 cache (rows quantized in place, scales
    handed to the decode attention), two slots of different lengths."""
    jcfg = jax_tiny()
    tree = jax_param_tree(jcfg, seed=4)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = from_jax_params(tree, qwen25vl_tiny(), "cpu")
    cfg = jcfg.text
    rng = np.random.RandomState(9)
    shape = (cfg.num_hidden_layers, 2, 40, cfg.num_key_value_heads,
             cfg.head_dim)
    kf = rng.randn(*shape).astype(np.float32)
    vf = rng.randn(*shape).astype(np.float32)
    k8, ks = jlm.quantize_kv(jnp.asarray(kf))
    v8, vs = jlm.quantize_kv(jnp.asarray(vf))
    lens = np.tile(np.asarray([[17, 31]], np.int32),
                   (cfg.num_hidden_layers, 1))
    jc = jlm.QuantKVCache(k=k8, v=v8, k_scale=ks, v_scale=vs,
                          length=jnp.asarray(lens))
    tc = tlm.QuantKVCache(
        k=torch.from_numpy(np.array(k8)), v=torch.from_numpy(np.array(v8)),
        k_scale=torch.from_numpy(np.array(ks)),
        v_scale=torch.from_numpy(np.array(vs)),
        length=torch.from_numpy(lens.astype(np.int64)))
    x = rng.randn(2, 1, cfg.hidden_size).astype(np.float32)
    pos = np.asarray([40, 55])[None, :, None].repeat(3, 0)
    jh, jc2 = jlm.lm_decode_step(jparams["lm"], jc, jnp.asarray(x),
                                 jnp.asarray(pos), cfg)
    th, tc2 = tlm.lm_decode_step(tparams.lm, tc, torch.from_numpy(x),
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=0)
    assert isinstance(tc2, tlm.QuantKVCache) and tc2.k is tc.k
    assert tc2.length.tolist() == np.asarray(jc2.length).tolist()
    for b, n in enumerate((17, 31)):  # the new rows, dequantized
        got = tlm.dequantize_kv(tc.k[:, b, n], tc.k_scale[:, b, n],
                                torch.float32).numpy()
        want = np.asarray(jlm.dequantize_kv(
            jc2.k[:, b, n], jc2.k_scale[:, b, n], jnp.float32))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
