"""Model/selector configuration dataclasses and presets.

The same dataclasses and presets as ``visionselector_tpu.core.config``
(the Qwen2.5-VL family, and LLaVA-OneVision-1.5 with its MoE variant),
with ``torch_dtype`` in place of ``jax_dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Qwen2.5-VL-style dynamic-resolution ViT configuration."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    tokens_per_second: int = 2
    window_size: int = 112
    out_hidden_size: int = 2048
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size * self.spatial_merge_size

    @property
    def patch_dim(self) -> int:
        """Flattened patch input dim: C * temporal_patch * patch * patch."""
        return self.in_channels * self.temporal_patch_size * self.patch_size**2


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Decoder configuration: the Qwen2.5 decoder (GQA, M-RoPE, qkv bias),
    or with the Qwen3 flags (``head_dim_override``, ``qk_norm``, no
    ``attention_bias``, 1-D rope with ``mrope`` off) the LLaVA-OV-1.5 text
    model; ``num_experts > 0`` gives every layer the Qwen3-MoE MLP
    (``num_experts_per_tok`` routed experts of width
    ``moe_intermediate_size``, renormalised under ``norm_topk_prob``)."""

    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    tie_word_embeddings: bool = True
    hidden_act: str = "silu"
    max_position_embeddings: int = 128000
    head_dim_override: Optional[int] = None
    qk_norm: bool = False
    attention_bias: bool = True
    mrope: bool = True
    num_experts: int = 0
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 768
    norm_topk_prob: bool = True

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class SelectorConfig:
    """Learnable Importance Scorer + top-k selection settings."""

    in_features: int = 2048
    hidden_dim: int = 1024
    init_scale: float = 1e-4
    budget: float = 0.2
    bisection_iters: int = 64


@dataclasses.dataclass(frozen=True)
class VLConfig:
    """Full vision-language model configuration."""

    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    selector: Optional[SelectorConfig] = None

    # Special token ids (Qwen2.5-VL vocabulary).
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    eos_token_id: int = 151645  # <|im_end|>
    pad_token_id: int = 151643

    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def with_selector(self, budget: float = 0.2) -> "VLConfig":
        sel = SelectorConfig(
            in_features=self.vision.out_hidden_size,
            hidden_dim=self.vision.out_hidden_size // 2,
            budget=budget,
        )
        return dataclasses.replace(self, selector=sel)


@dataclasses.dataclass(frozen=True)
class RiceVisionConfig:
    """RICE ViT (LLaVA-OneVision-1.5): no windowing, a learned CLS token per
    image, LayerNorm blocks, conv2d patch embed (temporal patch 1)."""

    depth: int = 24
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 1
    layer_norm_eps: float = 1e-5
    text_hidden_size: int = 4096  # merger output dim
    hidden_act: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size * self.spatial_merge_size

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2


@dataclasses.dataclass(frozen=True)
class OVConfig:
    """LLaVA-OneVision-1.5: RICE vision tower + Qwen3 text model."""

    vision: RiceVisionConfig = dataclasses.field(
        default_factory=RiceVisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    selector: Optional[SelectorConfig] = None

    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    eos_token_id: int = 151645
    pad_token_id: int = 151643

    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def with_selector(self, budget: float = 0.2) -> "OVConfig":
        sel = SelectorConfig(
            in_features=self.vision.text_hidden_size,
            hidden_dim=self.vision.text_hidden_size // 2,
            budget=budget,
        )
        return dataclasses.replace(self, selector=sel)


def llava_ov15_8b() -> OVConfig:
    """LLaVA-OneVision-1.5-8B shapes (RICE ViT + Qwen3-8B text)."""
    return OVConfig(
        vision=RiceVisionConfig(text_hidden_size=4096),
        text=TextConfig(
            vocab_size=151936,
            hidden_size=4096,
            intermediate_size=12288,
            num_hidden_layers=36,
            num_attention_heads=32,
            num_key_value_heads=8,
            head_dim_override=128,
            qk_norm=True,
            attention_bias=False,
            mrope=False,
            tie_word_embeddings=False,
        ),
    )


def llava_ov_tiny() -> OVConfig:
    """CPU-testable RICE + Qwen3 config (every structural feature kept)."""
    return OVConfig(
        vision=RiceVisionConfig(
            depth=2,
            hidden_size=64,
            intermediate_size=128,
            num_heads=4,
            text_hidden_size=96,
        ),
        text=TextConfig(
            vocab_size=151936,
            hidden_size=96,
            intermediate_size=192,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim_override=32,
            qk_norm=True,
            attention_bias=False,
            mrope=False,
            tie_word_embeddings=True,
        ),
        dtype="float32",
    )


def llava_ov_moe_tiny() -> OVConfig:
    """CPU-testable RICE + Qwen3-MoE config (the LLaVA-OV-1.5 MoE variant:
    128 experts / top-8 at scale; 4 experts / top-2 here)."""
    base = llava_ov_tiny()
    return dataclasses.replace(
        base,
        text=dataclasses.replace(
            base.text,
            num_experts=4,
            num_experts_per_tok=2,
            moe_intermediate_size=64,
        ),
    )


def qwen25vl_3b() -> VLConfig:
    """Qwen2.5-VL-3B-Instruct shapes."""
    return VLConfig(
        vision=VisionConfig(out_hidden_size=2048),
        text=TextConfig(
            hidden_size=2048,
            intermediate_size=11008,
            num_hidden_layers=36,
            num_attention_heads=16,
            num_key_value_heads=2,
            mrope_section=(16, 24, 24),
            tie_word_embeddings=True,
        ),
    )


def qwen25vl_7b() -> VLConfig:
    """Qwen2.5-VL-7B-Instruct shapes."""
    return VLConfig(
        vision=VisionConfig(out_hidden_size=3584),
        text=TextConfig(
            vocab_size=152064,
            hidden_size=3584,
            intermediate_size=18944,
            num_hidden_layers=28,
            num_attention_heads=28,
            num_key_value_heads=4,
            mrope_section=(16, 24, 24),
            tie_word_embeddings=False,
        ),
    )


def qwen25vl_tiny() -> VLConfig:
    """Tiny CPU-testable config preserving all structural features:
    windowed + full attention layers, 2x2 spatial merge, GQA, M-RoPE
    sections, tied embeddings."""
    return VLConfig(
        vision=VisionConfig(
            depth=4,
            hidden_size=64,
            intermediate_size=128,
            num_heads=4,
            out_hidden_size=96,
            fullatt_block_indexes=(1, 3),
            window_size=56,  # 2 merged positions per window side
        ),
        text=TextConfig(
            vocab_size=151936,  # keep real special-token ids valid
            hidden_size=96,
            intermediate_size=192,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            mrope_section=(4, 4, 4),  # sums to head_dim//2 = 12
            tie_word_embeddings=True,
        ),
        dtype="float32",
    )
