"""The port's packed rows (``--data-flatten``) against the JAX package's on
qwen25vl_tiny: ``build_packed_train_sample`` field for field (the port on
the reference's classic layout with ``align_windows=False``; on its own
window-aligned layout the text fields equal), ``pack_text_samples``, the
refusals where the reference asserts, ``api.train._packed_stream``'s rows,
and the selector loss and scorer gradients of a batch of packed rows.

Records come from ``ConversationDataset`` over seeded PNGs with
``test_torch_train.StubTokenizer``; weights from ``jax_param_tree``; fp32
throughout. Tolerances are stated where used: fp32 sum-order differences
relative to each tensor's largest |value|, or absolute where the values
are O(1).
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_train import StubTokenizer
from torch_port_params import jax_param_tree
from torch_ov_params import one_thread  # noqa: F401 (autouse)

from visionselector_tpu.api import train as japi
from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.train import data as jdata
from visionselector_tpu.train import dataset as jdataset
from visionselector_tpu.train import train_step as jstep
from visionselector_tpu_torch.api import train as tapi
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.train import data as tdata
from visionselector_tpu_torch.train import dataset as tdataset
from visionselector_tpu_torch.train import loss as tloss
from visionselector_tpu_torch.train import train_step as tstep

S_BUCKET, T_BUCKET, BUDGET = 256, 512, 0.25
K_MAX = max(1, int(S_BUCKET // 4 * BUDGET))
# 112x112: 64 patches (16 merged); 84x112: 48 patches, ragged windows
SHAPES = [(112, 112), (84, 112), (112, 112), (84, 112), (112, 112)]
# the text fields, equal on either vision layout
TEXT_FIELDS = ("input_ids", "labels", "position_ids", "seg_ids",
               "image_positions", "num_merged", "k")


def _rel_err(got, want):
    """max |got - want| over the largest |want|."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Five one-image records, then one of two images (which packing
    routes through the single-sample builder)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("packing")
    rng = np.random.RandomState(0)
    recs = []
    for i, hw in enumerate(SHAPES):
        Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(
            root / f"{i}.png")
        recs.append({"id": i, "image": f"{i}.png", "conversations": [
            {"from": "human", "value": f"<image>Q{i}?"},
            {"from": "gpt", "value": "A" * (i + 1)}]})
    recs.append({"id": 5, "image": ["0.png", "1.png"], "conversations": [
        {"from": "human", "value": "<image>and<image>?"},
        {"from": "gpt", "value": "B"}]})
    ann = root / "data.jsonl"
    with open(ann, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return str(ann), str(root)


@pytest.fixture(scope="module")
def datasets(data_dir):
    ann, root = data_dir
    tok = StubTokenizer()
    return (jdataset.ConversationDataset(ann, root, tok),
            tdataset.ConversationDataset(ann, root, tok))


def _packed(datasets, idx, align_windows):
    jds, tds = datasets
    want = jdataset.build_packed_train_sample(
        jax_tiny(), [jds[i] for i in idx], BUDGET, S_BUCKET, T_BUCKET)
    got = tdataset.build_packed_train_sample(
        qwen25vl_tiny(), [tds[i] for i in idx], BUDGET, S_BUCKET, T_BUCKET,
        align_windows=align_windows)
    return got, want


@pytest.mark.parametrize("idx", [(0,), (0, 1), (1, 2, 3)])
def test_packed_sample_matches_jax_field_for_field(datasets, idx):
    """Every field of the reference's packed sample equal bit for bit on
    its classic layout but the kv bounds (the port builds them at its
    64-row tile); segment ids 1..n, each sample's first label ignored and
    its M-RoPE ids restarting at 0; on the aligned layout the text fields
    equal the reference's and every window sits in one diag tile."""
    got, want = _packed(datasets, idx, align_windows=False)
    for f in want._fields:
        if not f.endswith("kv_bounds"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
    seg = np.asarray(got.seg_ids)
    assert sorted(set(seg) - {0}) == list(range(1, len(idx) + 1))
    for s in range(1, len(idx) + 1):
        first = np.argmax(seg == s)
        assert got.labels[first] == tloss.IGNORE_INDEX
        assert (got.position_ids[:, first] == 0).all()
    aligned, _ = _packed(datasets, idx, align_windows=True)
    for f in TEXT_FIELDS:
        np.testing.assert_array_equal(getattr(aligned, f), getattr(want, f),
                                      err_msg=f)
    assert bool(aligned.window_diag)


def test_packed_sample_refusals(datasets):
    """Where the reference asserts the port raises ValueError: a record of
    two images, a record without an image, a row past the text bucket."""
    _, tds = datasets
    cfg = qwen25vl_tiny()
    with pytest.raises(ValueError, match="multi-image"):
        tdataset.build_packed_train_sample(cfg, [tds[0], tds[5]], BUDGET,
                                           S_BUCKET, T_BUCKET)
    with pytest.raises(ValueError, match="image records"):
        tdataset.build_packed_train_sample(
            cfg, [dict(tds[0], image=None)], BUDGET, S_BUCKET, T_BUCKET)
    with pytest.raises(ValueError, match="text bucket"):
        tdataset.build_packed_train_sample(cfg, [tds[0], tds[1]], BUDGET,
                                           S_BUCKET, 128)


@pytest.mark.parametrize("t_bucket", [64, 150, 1000])
def test_pack_text_samples_matches_jax(t_bucket):
    """First-fit groups and sizes equal to the reference's plan."""
    rng = np.random.RandomState(t_bucket)
    samples = [{"ids": list(range(n))} for n in rng.randint(1, 60, 40)]
    assert (tdataset.pack_text_samples(samples, t_bucket)
            == jdataset.pack_text_samples(samples, t_bucket))


def test_packed_stream_rows_match_jax(datasets):
    """``api.train._packed_stream`` yields the reference stream's rows
    (text fields equal) over the dataset twice round: the first-fit groups
    bounded by the text bucket, the two-image record unpacked between
    them. The vision bucket leaves room on either layout, so the text
    bucket decides both streams' groups."""
    jds, tds = datasets
    args = SimpleNamespace(text_bucket=T_BUCKET, vision_bucket=S_BUCKET,
                           budget=BUDGET)
    jstream = japi._packed_stream(jax_tiny(), jds, args,
                                  jdataset.build_sample_from_record)
    tstream = tapi._packed_stream(qwen25vl_tiny(), tds, args,
                                  tdataset.build_sample_from_record)
    segs = []
    for _ in range(6):
        want, got = next(jstream), next(tstream)
        for f in TEXT_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        segs.append(int(np.asarray(got.seg_ids).max()))
    assert max(segs) > 1 and 1 in segs, segs  # packed rows and the single


@pytest.fixture(scope="module")
def packed_batches(datasets):
    """(JAX batch, port batch) of two packed rows: the reference on its
    classic layout, the port on the aligned one it trains on."""
    jds, tds = datasets
    js, ts = [], []
    for idx in ((0, 1), (2, 3, 4)):
        js.append(jdataset.build_packed_train_sample(
            jax_tiny(), [jds[i] for i in idx], BUDGET, S_BUCKET, T_BUCKET))
        ts.append(tdataset.build_packed_train_sample(
            qwen25vl_tiny(), [tds[i] for i in idx], BUDGET, S_BUCKET,
            T_BUCKET))
    return (jax.tree.map(jnp.asarray, jdata.stack_samples(js)),
            tloss.to_device(tdata.stack_samples(ts), "cpu"))


def test_packed_selector_loss_and_gradients_match_jax(packed_batches):
    """The batch loss of two packed rows (joint top-k over each row's
    images, per-segment causal attention) within 1e-5 of JAX's, and the
    scorer gradients within 1e-4 of each tensor's max |value| (but q_bias,
    whose gradient is zero analytically: within 1e-6 of the largest on
    both sides)."""
    jb, tb = packed_batches
    tree = jax_param_tree(jax_tiny(), seed=5, scorer_std=0.02)
    jparams = jax.tree.map(jnp.asarray, tree)
    (jl, _), want = jax.jit(jax.value_and_grad(
        lambda sp: jstep.batch_loss(sp, jparams, jb, jax_tiny(),
                                    jnp.asarray(1.3), K_MAX),
        has_aux=True))(jparams["scorer"])
    params = from_jax_params(tree, qwen25vl_tiny(), "cpu")
    tstep.init_train_state(params, tstep.ScheduleConfig())
    loss, _ = tstep.batch_loss(params, tb, qwen25vl_tiny(), 1.3, K_MAX)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=1e-5,
                               rtol=0)
    top = max(float(np.abs(want[n]).max()) for n in want)
    for name, p in params.scorer.named_parameters():
        if name == "q_bias":
            assert np.abs(want[name]).max() < 1e-6 * top
            assert p.grad.abs().max() < 1e-6 * top
        else:
            assert _rel_err(p.grad.numpy(), want[name]) < 1e-4, name
