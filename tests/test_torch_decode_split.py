"""The decode kernel's schedule, mirrored in plain PyTorch, against the JAX
package: ``decode_split_ranges_plain`` (each rank's live-tile range) and
``decode_split_plain`` (per-rank online-softmax states merged as the
cluster merges them) for clusters of 1, 8 and 16 ranks, t_c 1 and 4, float
and int8 caches, and lengths 0, 1, 63, 64, 65 and T - t_c. fp32, atol 1e-5
against ``decode_blocked_plain`` and the Pallas ``_decode_blocked_pallas``
in interpret mode (sum-order differences of the merge), as in
``test_torch_decode.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionselector_tpu.kernels import attention as jattn
from visionselector_tpu_torch.kernels import attention as tattn

ATOL = 1e-5
T, HQ, HKV, D = 256, 16, 2, 64  # four 64-key tiles; GQA n_rep 8
TILE = 64


def _bases(t_c):
    return np.asarray([0, 1, 63, 64, 65, T - t_c], np.int64)


def _inputs(seed, t_c, quant):
    rng = np.random.RandomState(seed)
    b = len(_bases(t_c))
    q = rng.randn(b, t_c, HQ, D).astype(np.float32)
    if quant:
        k = rng.randint(-127, 128, (b, T, HKV, D)).astype(np.int8)
        v = rng.randint(-127, 128, (b, T, HKV, D)).astype(np.int8)
        ks = (rng.rand(b, T, HKV) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(b, T, HKV) * 0.02 + 1e-3).astype(np.float32)
    else:
        k = rng.randn(b, T, HKV, D).astype(np.float32)
        v = rng.randn(b, T, HKV, D).astype(np.float32)
        ks = vs = None
    return q, k, v, ks, vs, _bases(t_c)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("cluster", [1, 8, 16])
@pytest.mark.parametrize("t_c", [1, 4])
def test_ranges_cover_each_live_tile_once(cluster, t_c):
    """Every live tile of each slot in exactly one rank, in rank order, and
    none past the JAX kernel's clamped kv index."""
    base = _bases(t_c)
    ranges = tattn.decode_split_ranges_plain(torch.from_numpy(base), t_c, T,
                                             cluster).numpy()
    assert ranges.shape == (len(base), cluster, 2)
    for b, n in enumerate(base):
        # _decode_blocked_pallas's kv_index: the last tile it maps
        last = max((int(n) + t_c + TILE - 1) // TILE - 1, 0)
        lo, hi = ranges[b, :, 0], ranges[b, :, 1]
        assert (lo <= hi).all() and lo[0] == 0
        assert (lo[1:] == hi[:-1]).all()  # contiguous, no overlap, no gap
        assert hi[-1] == min(last + 1, T // TILE)
        sizes = hi - lo
        assert sizes.max() - sizes.min() <= 1  # balanced


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("cluster", [1, 8, 16])
@pytest.mark.parametrize("t_c", [1, 4])
def test_split_plain_matches_blocked_and_pallas(t_c, cluster, quant):
    q, k, v, ks, vs, base = _inputs(31 + t_c + 2 * quant + cluster, t_c,
                                    quant)
    got = tattn.decode_split_plain(_t(q), _t(k), _t(v), _t(base), None,
                                   _t(ks), _t(vs), cluster)
    blocked = tattn.decode_blocked_plain(_t(q), _t(k), _t(v), _t(base), None,
                                         _t(ks), _t(vs))
    want = jattn._decode_blocked_pallas(
        _j(q), _j(k), _j(v), _j(base.astype(np.int32)), D**-0.5, TILE,
        interpret=True, k_scale=_j(ks), v_scale=_j(vs))
    np.testing.assert_allclose(got.numpy(), blocked.numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("cluster", [1, 8, 16])
def test_split_plain_row_without_keys_is_zero(cluster):
    """base_len -1 at t_c 1 leaves chunk row 0 no key (every rank empty):
    exactly 0, no NaN; the other slots are untouched."""
    q, k, v, _, _, base = _inputs(41, 1, False)
    base[2] = -1
    got = tattn.decode_split_plain(_t(q), _t(k), _t(v), _t(base),
                                   cluster=cluster)
    assert torch.isfinite(got).all()
    assert (got[2] == 0).all()
    np.testing.assert_allclose(
        got.numpy(), tattn.decode_blocked_plain(
            _t(q), _t(k), _t(v), _t(base)).numpy(), atol=ATOL, rtol=0)


def test_split_plain_dropped_rank_changes_the_output():
    """The merge fault the card checks plant: the last rank (which holds
    each slot's last live tile) left out moves the output far past the
    tolerance."""
    q, k, v, _, _, base = _inputs(42, 1, False)
    good = tattn.decode_split_plain(_t(q), _t(k), _t(v), _t(base), cluster=8)
    bad = tattn.decode_split_plain(_t(q), _t(k), _t(v), _t(base), cluster=8,
                                   drop_rank=7)
    assert (bad - good).abs().max().item() > 100 * ATOL
