"""LLaVA-OneVision-1.5 weights in the port: HF safetensors directories that
the tests write themselves (``save_ov_checkpoint``), read by the port's
``load_ov_checkpoint`` and by the JAX package's; the two must hold the
same bits. Also ``ov_config_from_hf`` against the JAX reader, the
Qwen3 layer table, and ``api.merge_model`` (assemble, the activation
cosine check, the CLI on the CPU)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch_ov_params import (  # noqa: F401 (one_thread: autouse fixture)
    EOS,
    configs,
    one_thread,
    requests,
)

from visionselector_tpu.models.llava_ov15 import model as jmodel
from visionselector_tpu.models.llava_ov15 import weights as jweights
from visionselector_tpu_torch.api import merge_model
from visionselector_tpu_torch.models.llava_ov15 import model as tmodel
from visionselector_tpu_torch.models.llava_ov15 import weights as tweights
from visionselector_tpu_torch.models.qwen25vl.weights import lm_layer_table


def _port_model(cfg, seed):
    """Random port weights with non-trivial norm scales and biases (so a
    swapped or dropped one shows)."""
    p = tmodel.init_ov_params(cfg, torch.Generator().manual_seed(seed),
                              "cpu")
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, t in p.named_parameters():
            if name.endswith(("_scale", "_bias")):
                t.add_(torch.randn(t.shape, generator=g) * 0.1)
    return p


LAYOUTS = {
    # (vision prefix, text prefix, tied head, shards)
    "new prefixes, tied, one file": ("model.visual.",
                                     "model.language_model.", True, 1),
    "old prefixes, untied, 3 shards": ("visual.", "model.", False, 3),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_load_ov_checkpoint_bit_equal_to_jax_loader(tmp_path, layout):
    vis, lmp, tied, shards = LAYOUTS[layout]
    jcfg, tcfg = configs()
    tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(
        tcfg.text, tie_word_embeddings=tied))
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(
        jcfg.text, tie_word_embeddings=tied))
    src = _port_model(tcfg, seed=1)
    tweights.save_ov_checkpoint(src, tcfg, str(tmp_path), shards=shards,
                                vis_prefix=vis, lm_prefix=lmp)
    assert len([f for f in os.listdir(tmp_path)
                if f.endswith(".safetensors")]) == shards
    got = tweights.load_ov_checkpoint(str(tmp_path), tcfg, "cpu")
    jtree = jweights.load_ov_checkpoint(str(tmp_path), jcfg)
    want = tweights.ov_from_jax_params(jax.tree.map(np.asarray, jtree),
                                       tcfg, "cpu")
    got_sd, want_sd, src_sd = (m.state_dict() for m in (got, want, src))
    assert got_sd.keys() == want_sd.keys() == src_sd.keys()
    assert ("lm.lm_head_kernel" in got_sd) != tied
    assert "scorer.q_kernel" in got_sd
    for name in got_sd:
        assert torch.equal(got_sd[name], want_sd[name]), name
        assert torch.equal(got_sd[name], src_sd[name]), name
    assert got.visual.class_pos_emb.dtype == torch.float32


def test_loaded_checkpoint_generates_like_jax(tmp_path):
    """The engine on the port-loaded weights and the JAX engine on the
    JAX-loaded weights of one directory: the same greedy tokens."""
    jcfg, tcfg = configs()
    tweights.save_ov_checkpoint(_port_model(tcfg, seed=2), tcfg,
                                str(tmp_path))
    r = requests()["image"]
    want = jmodel.OVEngine(jcfg, jweights.load_ov_checkpoint(
        str(tmp_path), jcfg), use_selector=False).generate(
            **r, max_new_tokens=6, eos_token_ids=EOS)
    got = tmodel.OVEngine(tcfg, tweights.load_ov_checkpoint(
        str(tmp_path), tcfg, "cpu"), use_selector=False,
        device="cpu").generate(**r, max_new_tokens=6, eos_token_ids=EOS)
    assert got.tokens == want.tokens


def test_bf16_sharded_round_trip(tmp_path):
    """bf16 weights (the card's dtype) written and read back bit for bit;
    the CLS rotary row and the scorer stay fp32."""
    _, tcfg = configs()
    src = tmodel.init_ov_params(tcfg, torch.Generator().manual_seed(3),
                                "cpu", torch.bfloat16)
    tweights.save_ov_checkpoint(src, tcfg, str(tmp_path), shards=2)
    back = tweights.load_ov_checkpoint(str(tmp_path), tcfg, "cpu",
                                       dtype=torch.bfloat16)
    for (name, a), (_, b) in zip(src.state_dict().items(),
                                 back.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert back.visual.class_pos_emb.dtype == torch.float32
    assert back.lm.embed_tokens.dtype == torch.bfloat16


HF_CONFIGS = {
    "tiny written by the port": None,
    "8B as released, MoE fields": {
        "vision_config": {"depth": 24, "hidden_size": 1024,
                          "intermediate_size": 4096, "num_heads": 16,
                          "patch_size": 14, "spatial_merge_size": 2,
                          "text_hidden_size": 4096},
        "text_config": {"vocab_size": 151936, "hidden_size": 4096,
                        "intermediate_size": 12288,
                        "num_hidden_layers": 36, "num_attention_heads": 32,
                        "num_key_value_heads": 8, "head_dim": 128,
                        "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
                        "num_experts": 0},
        "tie_word_embeddings": False, "image_token_id": 151655,
        "video_token_id": 151656},
}


@pytest.mark.parametrize("case", list(HF_CONFIGS))
def test_ov_config_from_hf_matches_jax(tmp_path, case):
    raw = HF_CONFIGS[case] or tweights.ov_hf_config(configs()[1])
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    got = tweights.ov_config_from_hf(str(tmp_path))
    want = jweights.ov_config_from_hf(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if HF_CONFIGS[case] is None:  # the writer round-trips the tiny config
        tiny = configs()[1]
        assert got.vision == tiny.vision
        assert got.text == tiny.text
    else:
        from visionselector_tpu_torch.core.config import llava_ov15_8b

        assert got.vision == llava_ov15_8b().vision
        assert got.text == llava_ov15_8b().text


def test_qwen3_layer_table_names():
    """A Qwen3 layer's HF names: q/k norms, no biases; a Qwen2.5 layer's:
    biases, no norms."""
    from visionselector_tpu_torch.core.config import qwen25vl_tiny

    ov = {hf for hf, _, _ in lm_layer_table(configs()[1].text)}
    qwen = {hf for hf, _, _ in lm_layer_table(qwen25vl_tiny().text)}
    assert ov - qwen == {"self_attn.q_norm.weight", "self_attn.k_norm.weight"}
    assert qwen - ov == {"self_attn.q_proj.bias", "self_attn.k_proj.bias",
                         "self_attn.v_proj.bias"}


def test_moe_checkpoint_config_loads_and_decoder_refuses(tmp_path):
    """A config.json with the MoE fields loads (as the JAX reader reads
    it), and the decoder it describes builds with the router and experts
    and runs the engine."""
    raw = tweights.ov_hf_config(configs()[1])
    raw["text_config"]["num_experts"] = 4
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    cfg = tweights.ov_config_from_hf(str(tmp_path))
    assert cfg.text.num_experts == 4
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jweights.ov_config_from_hf(str(tmp_path)))
    params = tmodel.init_ov_params(
        dataclasses.replace(cfg, dtype="float32"),
        torch.Generator().manual_seed(0), "cpu")
    assert params.lm.layers[0].expert_gate_kernel.shape[0] == 4
    res = tmodel.OVEngine(cfg, params, device="cpu").generate(
        **requests()["image"], max_new_tokens=2, eos_token_ids=EOS)
    assert len(res.tokens) == 2


# -- merge_model -----------------------------------------------------------


def test_merge_assemble_and_sanity_check():
    """Transplanted modules are the sources' (cosine 1); a module from
    another model is caught (cosine below the CLI's 0.999)."""
    _, cfg = configs()
    a, b = _port_model(cfg, 4), _port_model(cfg, 5)
    merged = merge_model.assemble(a.visual, b.lm, a.scorer, cfg)
    assert merged.visual is a.visual and merged.lm is b.lm
    report = merge_model.sanity_check(merged, cfg, a.visual, b.lm)
    assert report == {"visual": pytest.approx(1.0, abs=1e-6),
                      "lm": pytest.approx(1.0, abs=1e-6)}
    wrong = merge_model.sanity_check(merged, cfg, b.visual, a.lm)
    assert max(wrong.values()) < 0.999


def test_merge_main_from_two_checkpoints(tmp_path, capsys):
    """The CLI on two HF directories: the merged directory holds the first
    one's tower and scorer and the second one's text model, bit for bit
    (each read in its config's dtype, bf16, as the CLI reads them)."""
    _, cfg = configs()

    def load(name):
        d = str(tmp_path / name)
        return tweights.load_ov_checkpoint(d, tweights.ov_config_from_hf(d),
                                           "cpu")

    for name, seed in (("a", 6), ("b", 7)):
        tweights.save_ov_checkpoint(_port_model(cfg, seed), cfg,
                                    str(tmp_path / name))
    a, b = load("a"), load("b")
    out = tmp_path / "out"
    rc = merge_model.main(["--vision-path", str(tmp_path / "a"),
                           "--lm-path", str(tmp_path / "b"),
                           "--output-dir", str(out), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and printed["ok"]
    with open(out / "merge_report.json") as f:
        assert json.load(f)["ok"]
    merged = load("out/merged")
    assert merged.lm.embed_tokens.dtype == torch.bfloat16
    for mod, src in ((merged.visual, a.visual), (merged.lm, b.lm),
                     (merged.scorer, a.scorer)):
        for (n, x), (_, y) in zip(mod.state_dict().items(),
                                  src.state_dict().items()):
            assert torch.equal(x, y), n


def test_merge_main_smoke(tmp_path, capsys):
    rc = merge_model.main(["--smoke", "--device", "cpu", "--output-dir",
                           str(tmp_path)])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["ok"] and set(printed["cosine"]) == {"visual", "lm"}
    assert os.path.isfile(tmp_path / "merged" / "config.json")
