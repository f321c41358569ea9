"""The port's full-attention ablation (K7) against the JAX package's TPU
bench kernel ``tools/bench_fullattn_ablate.py:_kernel``, run here through a
``pl.pallas_call(..., interpret=True)`` built with the BlockSpecs of that
file's ``variant`` (which has no interpret switch; ``tools/`` stays as it
is). Same numpy inputs from a seed go to both; fp32.

Tolerances: with the exp, atol 3e-5 / rtol 1e-4 (fp32 online softmax
against a dense one, as the JAX package's kernel tests); without it,
atol 1e-4 / rtol 1e-4 (p = the logits themselves, so the output is a sum
of ~200 terms of size ~1 and fp32 sum-order noise is ~1e-5).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from visionselector_tpu_torch.kernels import attention as tattn
from visionselector_tpu_torch.tools import bench_fullattn_ablate as tbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK, HPP = 64, 2


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_fullattn_ablate",
        os.path.join(REPO, "tools", "bench_fullattn_ablate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_variant(jbench, q, k, v, seg, do_mask, do_exp):
    """``variant`` of the JAX bench with interpret=True and a 64-row block."""
    b, s, h, d = q.shape
    qt, kt, vt = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v))
    kernel = functools.partial(jbench._kernel, scale=d**-0.5, block_k=BLOCK,
                               num_heads=HPP, do_mask=do_mask, do_exp=do_exp)
    out = pl.pallas_call(
        kernel,
        grid=(b, h // HPP, s // BLOCK),
        in_specs=[
            pl.BlockSpec((1, HPP, BLOCK, d), lambda ib, ih, iq: (ib, ih, iq, 0)),
            pl.BlockSpec((1, HPP, s, d), lambda ib, ih, iq: (ib, ih, 0, 0)),
            pl.BlockSpec((1, HPP, s, d), lambda ib, ih, iq: (ib, ih, 0, 0)),
            pl.BlockSpec((1, BLOCK), lambda ib, ih, iq: (ib, iq)),
            pl.BlockSpec((1, s), lambda ib, ih, iq: (ib, 0)),
        ],
        out_specs=pl.BlockSpec((1, HPP, BLOCK, d),
                               lambda ib, ih, iq: (ib, ih, iq, 0)),
        out_shape=jax.ShapeDtypeStruct((b, h, s, d), qt.dtype),
        interpret=True,
    )(qt, kt, vt, jnp.asarray(seg), jnp.asarray(seg))
    return np.asarray(out.transpose(0, 2, 1, 3))


def _inputs(s=256, h=4, d=16, pad=32):
    rng = np.random.RandomState(s + d)
    q, k, v = (rng.randn(1, s, h, d).astype(np.float32) for _ in range(3))
    seg = np.ones((1, s), np.int32)
    seg[:, -pad:] = 0
    return q, k, v, seg


@pytest.mark.parametrize("do_exp", [True, False])
@pytest.mark.parametrize("do_mask", [True, False])
def test_ablate_plain_matches_jax_bench_kernel(jbench, do_mask, do_exp):
    q, k, v, seg = _inputs()
    want = _jax_variant(jbench, q, k, v, seg, do_mask, do_exp)
    t = torch.from_numpy
    got = tattn.fullattn_ablate(t(q), t(k), t(v), t(seg), do_mask, do_exp)
    tol = dict(atol=3e-5, rtol=1e-4) if do_exp else dict(atol=1e-4,
                                                         rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    assert torch.equal(got, tattn.ablate_plain(t(q), t(k), t(v), t(seg),
                                               do_mask, do_exp))


def test_ablate_with_mask_and_exp_is_flash_without_bounds():
    q, k, v, seg = (torch.from_numpy(x) for x in _inputs(d=80))
    got = tattn.ablate_plain(q, k, v, seg)
    want = tattn.flash_plain(q, k, v, seg, seg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert (got[0, -32:] == 0).all()
    # without the mask the padding rows attend (and are attended) too
    assert (tattn.ablate_plain(q, k, v, seg, do_mask=False)[0, -32:]
            != 0).any()


def test_bench_entry_point_needs_a_card():
    q, k, v, seg = tbench.inputs(256, device="cpu")
    assert q.shape == (1, 256, 16, 80) and q.dtype == torch.bfloat16
    assert int(seg.sum()) == 256 - 128
    assert set(tbench.cases(q, k, v, seg)) == {
        "prod", "full_ablate", "nomask", "noexp", "bare"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tbench.main(["256"])
