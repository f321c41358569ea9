"""The port's Hugging Face checkpoint path against the JAX package's and
against ``transformers``: its own safetensors reader and writer, the HF
loader (bit-equal to the JAX loader through ``from_jax_params``, fp32 and
bf16 files, both prefix layouts, sharded over two files), ``config_from_hf``
on the flat and the nested config, scorer export round trips both ways,
logits of a tiny random ``transformers`` Qwen2.5-VL saved with
``save_pretrained`` (within the JAX test's own 2e-3 text-only and 5e-3
image-prefill tolerances, ``tests/test_hf_parity.py``), and
``api.predict --model-path``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from test_weights import make_hf_checkpoint

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import weights as jweights
from visionselector_tpu_torch.core import safetensors as st
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl import weights as tweights


@pytest.fixture(scope="module")
def hf_tensors(tmp_path_factory):
    """The synthetic HF-layout tensors of the tiny config (fp32 numpy)."""
    d = tmp_path_factory.mktemp("hf_src")
    return make_hf_checkpoint(str(d))


def _write(tensors, directory, file_dtype, nested, shards=2):
    """Write ``tensors`` in ``file_dtype`` with the port's writer, renamed to
    the transformers >= 4.52 layout when ``nested``."""
    out = {}
    for name, a in tensors.items():
        if nested and name.startswith("visual."):
            name = "model." + name
        elif nested and name.startswith("model."):
            name = "model.language_model." + name[len("model."):]
        out[name] = torch.from_numpy(a).to(file_dtype)
    st.save_sharded(out, str(directory), shards=shards)
    return out


@pytest.mark.parametrize("file_dtype, nested, model_dtype", [
    (torch.float32, False, "float32"),
    (torch.bfloat16, True, "float32"),
    (torch.float32, True, "bfloat16"),
    (torch.bfloat16, False, "bfloat16"),
])
def test_hf_load_bit_equal_to_jax_loader(hf_tensors, tmp_path, file_dtype,
                                         nested, model_dtype):
    """Every parameter of the port's ``load_hf_checkpoint`` equals the JAX
    ``load_hf_checkpoint`` -> ``from_jax_params`` bit for bit (fp32 files
    cast to bf16 round to nearest even on both sides), the scorer fp32."""
    import jax

    _write(hf_tensors, tmp_path, file_dtype, nested)
    assert len([f for f in os.listdir(tmp_path)
                if f.endswith(".safetensors")]) == 2
    jcfg = dataclasses.replace(jax_tiny(), dtype=model_dtype)
    tcfg = dataclasses.replace(qwen25vl_tiny(), dtype=model_dtype)
    jtree = jax.tree.map(np.asarray,
                         jweights.load_hf_checkpoint(str(tmp_path), jcfg))
    want = tweights.from_jax_params(jtree, tcfg, "cpu")
    got = tweights.load_hf_checkpoint(str(tmp_path), tcfg, "cpu")
    got_p = dict(got.named_parameters())
    want_p = dict(want.named_parameters())
    assert got_p.keys() == want_p.keys() and "scorer.q_kernel" in got_p
    for name, p in want_p.items():
        assert got_p[name].dtype == p.dtype, name
        assert torch.equal(got_p[name], p), name
    assert got.scorer.q_kernel.dtype == torch.float32
    assert got.lm.embed_tokens.dtype == getattr(torch, model_dtype)


def test_to_hf_tensors_inverts_the_loader(hf_tensors, tmp_path):
    _write(hf_tensors, tmp_path, torch.float32, nested=False, shards=1)
    params = tweights.load_hf_checkpoint(str(tmp_path), qwen25vl_tiny(),
                                         "cpu")
    back = tweights.to_hf_tensors(params)
    assert back.keys() == hf_tensors.keys()
    for name, a in hf_tensors.items():
        assert torch.equal(back[name], torch.from_numpy(a)), name


def test_reader_keeps_bf16_raw_and_safetensors_reads_the_writer(tmp_path):
    """bf16 comes back as bf16 viewing the file's map (no fp32 copy); the
    ``safetensors`` package reads the port's file tensor for tensor, and
    the port reads the package's."""
    from safetensors import safe_open

    rng = np.random.RandomState(0)
    src = {"a.bf16": torch.from_numpy(rng.randn(3, 5).astype(np.float32)
                                      ).bfloat16(),
           "b.f32": torch.from_numpy(rng.randn(7).astype(np.float32)),
           "c.i64": torch.arange(4), "d.empty": torch.zeros(0, 3)}
    path = str(tmp_path / "x.safetensors")
    st.save_file(src, path)
    get = st.open_checkpoint(path)
    assert get.names == set(src)
    for name, t in src.items():
        got = get(name)
        assert got.dtype == t.dtype and torch.equal(got, t), name
    sf = st.SafetensorsFile(path)
    a = sf.get("a.bf16")
    base = sf._map.ctypes.data  # the tensor views the file's map
    assert a.dtype == torch.bfloat16
    assert base <= a.data_ptr() < base + sf._map.size
    with safe_open(path, framework="pt") as f:
        assert set(f.keys()) == set(src)
        for name, t in src.items():
            assert torch.equal(f.get_tensor(name), t), name
    # a file the safetensors package wrote, with its metadata header
    from safetensors.torch import save_file

    theirs = str(tmp_path / "theirs.safetensors")
    save_file({k: t for k, t in src.items() if t.numel()}, theirs,
              metadata={"format": "pt"})
    get2 = st.open_checkpoint(theirs)
    for name in get2.names:
        assert torch.equal(get2(name), src[name]), name
    with pytest.raises(KeyError):
        get("missing")
    with pytest.raises(FileNotFoundError):
        st.open_checkpoint(str(tmp_path / "nothing_here"))


def _config_json(nested: bool) -> dict:
    text = dict(vocab_size=151936, hidden_size=96, intermediate_size=192,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=1e5,
                rope_scaling={"type": "mrope", "mrope_section": [4, 4, 4]},
                tie_word_embeddings=False, max_position_embeddings=4096)
    top = dict(vision_config=dict(depth=4, hidden_size=64,
                                  intermediate_size=128, num_heads=4,
                                  out_hidden_size=96, window_size=56,
                                  fullatt_block_indexes=[1, 3]),
               image_token_id=151655, eos_token_id=151645)
    if nested:
        top["text_config"] = text
    else:
        top.update(text)
    return top


@pytest.mark.parametrize("nested", [False, True])
def test_config_from_hf_matches_jax(tmp_path, nested):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(_config_json(nested), f)
    j = jweights.config_from_hf(str(tmp_path))
    t = tweights.config_from_hf(str(tmp_path))
    assert dataclasses.asdict(t.vision) == dataclasses.asdict(j.vision)
    assert dataclasses.asdict(t.text) == dataclasses.asdict(j.text)
    for f in ("image_token_id", "video_token_id", "vision_start_token_id",
              "vision_end_token_id", "eos_token_id", "dtype"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.text.tie_word_embeddings is False
    assert t.text.mrope_section == (4, 4, 4)


def test_scorer_export_round_trips_with_jax(hf_tensors, tmp_path):
    """A port export read by the JAX loader, and a JAX export read by the
    port, both bit-equal to the scorer exported."""
    import jax.numpy as jnp

    _write(hf_tensors, tmp_path / "ckpt", torch.float32, nested=False)
    params = tweights.load_hf_checkpoint(str(tmp_path / "ckpt"),
                                         qwen25vl_tiny(), "cpu")
    port_file = str(tmp_path / "port" / "importance_scorer.safetensors")
    os.makedirs(os.path.dirname(port_file))
    tweights.export_scorer_to_safetensors(params.scorer, port_file)
    jsc = jweights.load_scorer_params(
        jweights._open_checkpoint(os.path.dirname(port_file)))
    for name, p in params.scorer.named_parameters():
        np.testing.assert_array_equal(np.asarray(jsc[name]),
                                      p.detach().numpy(), err_msg=name)

    rng = np.random.RandomState(1)
    jtree = {n: jnp.asarray(rng.randn(*p.shape).astype(np.float32))
             for n, p in params.scorer.named_parameters()}
    os.makedirs(tmp_path / "jax")
    jweights.export_scorer_to_safetensors(
        jtree, str(tmp_path / "jax" / "scorer.safetensors"))
    get = st.open_checkpoint(str(tmp_path / "jax"))
    got = tweights.load_scorer_params(get, qwen25vl_tiny(), "cpu")
    for name, p in got.named_parameters():
        assert torch.equal(p, torch.from_numpy(np.asarray(jtree[name]))), name
    assert tweights.load_scorer_params(
        st.open_checkpoint(str(tmp_path / "ckpt")), qwen25vl_tiny(), "cpu",
        prefix="nothing.") is None


# ------------------------------------------------- against transformers

@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """A tiny random HF Qwen2.5-VL saved with ``save_pretrained`` (the
    configuration of ``tests/test_hf_parity.py``)."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.Qwen2_5_VLConfig(
        vision_config=dict(
            depth=4, hidden_size=64, intermediate_size=128, num_heads=4,
            in_channels=3, patch_size=14, spatial_merge_size=2,
            temporal_patch_size=2, tokens_per_second=2, window_size=56,
            out_hidden_size=96, fullatt_block_indexes=[1, 3],
            hidden_act="silu",
        ),
        text_config=dict(
            vocab_size=151936, hidden_size=96, intermediate_size=192,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2,
            rope_scaling={"type": "mrope", "mrope_section": [4, 4, 4]},
            tie_word_embeddings=True, rms_norm_eps=1e-6, rope_theta=1e6,
        ),
        image_token_id=151655, video_token_id=151656,
        vision_start_token_id=151652, vision_end_token_id=151653,
    )
    torch.manual_seed(0)
    model = transformers.Qwen2_5_VLForConditionalGeneration(cfg).eval()
    d = str(tmp_path_factory.mktemp("hf_ckpt"))
    model.save_pretrained(d)
    return d, model


@pytest.fixture(scope="module")
def port_engine(hf_checkpoint):
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine

    path, _ = hf_checkpoint
    cfg = dataclasses.replace(tweights.config_from_hf(path), dtype="float32")
    params = tweights.load_hf_checkpoint(path, cfg, "cpu")
    assert params.scorer is None
    return QwenVLEngine(cfg, params, use_selector=False, device="cpu")


def test_text_only_logits_match_hf(hf_checkpoint, port_engine):
    _, hf_model = hf_checkpoint
    ids = np.random.RandomState(0).randint(10, 5000, 12)
    with torch.no_grad():
        want = hf_model(input_ids=torch.tensor(ids[None]),
                        attention_mask=torch.ones(1, 12, dtype=torch.long)
                        ).logits[0, -1].numpy()
    got = port_engine.generate(ids, max_new_tokens=1).logits.numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    assert int(got.argmax()) == int(want.argmax())


def test_image_prefill_logits_match_hf(hf_checkpoint, port_engine):
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    _, hf_model = hf_checkpoint
    rng = np.random.RandomState(1)
    img = (rng.rand(112, 140, 3) * 255).astype(np.uint8)
    pixels, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = np.asarray(expand_vision_tokens([100, 200, 300], [400, 500], grid))
    with torch.no_grad():
        want = hf_model(
            input_ids=torch.tensor(ids[None]),
            attention_mask=torch.ones(1, len(ids), dtype=torch.long),
            pixel_values=torch.tensor(pixels, dtype=torch.float32),
            image_grid_thw=torch.tensor(np.asarray(grid)),
        ).logits[0, -1].numpy()
    got = port_engine.generate(ids, pixels, grid, max_new_tokens=1)
    np.testing.assert_allclose(got.logits.numpy(), want, atol=5e-3,
                               rtol=5e-3)
    assert int(got.logits.argmax()) == int(want.argmax())


def test_predict_cli_loads_model_path(hf_checkpoint, tmp_path, capsys):
    """``api.predict --model-path`` on the saved directory, then on a copy
    with a trained scorer merged in (``--method selector`` then selects)."""
    import shutil

    from visionselector_tpu_torch.api import predict
    from visionselector_tpu_torch.core.params import init_random_
    from visionselector_tpu_torch.selector.scorer import Scorer

    path, _ = hf_checkpoint
    argv = ["--device", "cpu", "--max-new-tokens", "2", "--prompt-ids",
            "5,6,7"]
    assert predict.main(["--model-path", path] + argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["selector"] is False and len(out["tokens"]) >= 1
    merged = tmp_path / "merged"
    shutil.copytree(path, merged)
    scorer = Scorer(tweights.config_from_hf(path).with_selector().selector,
                    "cpu")
    init_random_(scorer, torch.Generator().manual_seed(0), std=0.02)
    tweights.export_scorer_to_safetensors(
        scorer, str(merged / "importance_scorer.safetensors"))
    assert predict.main(["--model-path", str(merged)] + argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["selector"] is True
    assert out["kept_vision_tokens"] < out["num_vision_tokens"]
