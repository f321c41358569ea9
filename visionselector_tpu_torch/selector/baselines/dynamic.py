"""Dynamic-Qwen: a trained token-selection predictor (Dynamic-LLaVA port).

Counterpart of ``visionselector_tpu.selector.baselines.dynamic``: a small
transformer scorer over the image hidden states at decoder layer
``target_layer``,

    down_mlp (LayerNorm -> Linear -> GELU) ->
    2 pre-LN encoder blocks (timm-style) ->
    [local features | policy-masked global mean] -> 3-layer MLP -> 2 logits,

fp32 weights in an ``nn.Module`` (matmul kernels ``[in, out]``, the
reference's names). Inference keeps the top ``int(N * budget)`` image
tokens ranked by ``log_softmax(logits)[..., 0]``. Training
(``train.dynamic_train``) samples a straight-through Gumbel keep mask
(``gumbel_keep_mask``) at an exponentially decayed temperature
(``tau_schedule``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visionselector_tpu_torch.core.params import add_params, init_random_


class PredictorBlock(nn.Module):
    """One pre-LN encoder block: timm ``Attention`` (q, k, v without bias,
    a projection with bias) and a GELU MLP."""

    def __init__(self, d_model: int, hidden: int, device):
        super().__init__()
        add_params(self, {
            "norm1_scale": (d_model,), "norm1_bias": (d_model,),
            "norm2_scale": (d_model,), "norm2_bias": (d_model,),
            "q_kernel": (d_model, d_model), "k_kernel": (d_model, d_model),
            "v_kernel": (d_model, d_model),
            "proj_kernel": (d_model, d_model), "proj_bias": (d_model,),
            "fc1_kernel": (d_model, hidden), "fc1_bias": (hidden,),
            "fc2_kernel": (hidden, d_model), "fc2_bias": (d_model,),
        }, device, torch.float32)


class Predictor(nn.Module):
    """The Dynamic-LLaVA VisionPredictor's weights, fp32."""

    def __init__(self, input_dim: int, d_model: int = 512,
                 num_heads: int = 8, mlp_ratio: float = 4.0,
                 num_layers: int = 2, device="cpu"):
        super().__init__()
        self.num_heads = num_heads
        add_params(self, {
            "down_ln_scale": (input_dim,), "down_ln_bias": (input_dim,),
            "down_kernel": (input_dim, d_model), "down_bias": (d_model,),
        }, device, torch.float32)
        self.blocks = nn.ModuleList(
            PredictorBlock(d_model, int(d_model * mlp_ratio), device)
            for _ in range(num_layers))
        add_params(self, {
            "out1_kernel": (d_model, d_model // 2),
            "out1_bias": (d_model // 2,),
            "out2_kernel": (d_model // 2, d_model // 4),
            "out2_bias": (d_model // 4,),
            "out3_kernel": (d_model // 4, 2), "out3_bias": (2,),
        }, device, torch.float32)

    def forward(self, x, policy=None):
        return predictor_forward(self, x, policy)


def init_predictor(input_dim: int, generator: torch.Generator, device,
                   **kwargs) -> Predictor:
    """A predictor with the reference's init rule (norm scales ones, biases
    zeros, kernels normal with std 0.02), drawn from ``generator``."""
    pred = Predictor(input_dim, device=device, **kwargs)
    init_random_(pred, generator, std=0.02)
    return pred


def _layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def predictor_forward(pred: Predictor, x: torch.Tensor,
                      policy: torch.Tensor | None = None) -> torch.Tensor:
    """x: [B, N, input_dim]; policy: [B, N, 1] keep mask (None = all kept).
    Returns logits [B, N, 2]."""
    b, n, _ = x.shape
    if policy is None:
        policy = torch.ones(b, n, 1, device=x.device)
    h = _layer_norm(x, pred.down_ln_scale, pred.down_ln_bias)
    h = F.gelu(h @ pred.down_kernel + pred.down_bias, approximate="none")
    h = h * policy.to(h.dtype)
    d_model = h.shape[-1]
    heads = pred.num_heads
    dh = d_model // heads
    for p in pred.blocks:
        y = _layer_norm(h, p.norm1_scale, p.norm1_bias)
        q = (y @ p.q_kernel).view(b, n, heads, dh)
        k = (y @ p.k_kernel).view(b, n, heads, dh)
        v = (y @ p.v_kernel).view(b, n, heads, dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * dh**-0.5
        probs = torch.softmax(logits, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        h = h + attn.reshape(b, n, d_model) @ p.proj_kernel + p.proj_bias
        y = _layer_norm(h, p.norm2_scale, p.norm2_bias)
        y = F.gelu(y @ p.fc1_kernel + p.fc1_bias, approximate="none")
        h = h + y @ p.fc2_kernel + p.fc2_bias
    c = h.shape[-1]
    local = h[..., : c // 2]
    pol = policy.float()
    global_feat = ((h[..., c // 2:] * pol).sum(dim=1, keepdim=True)
                   / pol.sum(dim=1, keepdim=True))
    h = torch.cat([local, global_feat.expand_as(local)], dim=-1)
    h = F.gelu(h @ pred.out1_kernel + pred.out1_bias, approximate="none")
    h = F.gelu(h @ pred.out2_kernel + pred.out2_bias, approximate="none")
    return h @ pred.out3_kernel + pred.out3_bias


def tau_schedule(step: int, total_steps: int, start: float = 1.0,
                 end: float = 0.1) -> float:
    """Exponential Gumbel temperature decay ``start * (end / start) ^
    (step / total)``, the fraction clipped to [0, 1], in the reference's
    fp32 arithmetic (``train_qwen_dynamic.py:72-76``; JAX
    ``baselines/dynamic.py:130-133``)."""
    f32 = np.float32
    frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0), f32(1))
    return float(f32(start) * f32(end / start) ** frac)


def gumbel_keep_mask(logits: torch.Tensor, tau, uniform=None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """Straight-through Gumbel-softmax keep decision (JAX
    ``baselines/dynamic.py:136-145``): logits [..., 2] -> keep [...], the
    hard one-hot's channel 0 (keep) in the forward, the soft sample's
    gradient in the backward (``hard + soft - soft.detach()``).

    ``uniform``: the U(0, 1) draws [..., 2] behind the Gumbel noise (the
    tests hand in the ones ``jax.random.uniform`` draws); None draws them
    from ``generator`` on the logits' device."""
    if uniform is None:
        uniform = torch.rand(logits.shape, generator=generator,
                             device=logits.device)
    g = -torch.log(-torch.log(uniform + 1e-10) + 1e-10)
    soft = torch.softmax((logits + g) / tau, dim=-1)
    hard = F.one_hot(soft.argmax(-1), 2).to(soft.dtype)
    return (hard + soft - soft.detach())[..., 0]


class DynamicSelect:
    """LLM-side trained selection strategy (plugs into the two-stage
    prefill): it reads only the hidden states at ``target_layer``.

    ``predictor``: a ``Predictor`` (e.g. ``weights.predictor_from_jax`` of
    a reference tree); None sizes one to the model's hidden width on first
    use, drawn from ``torch.Generator().manual_seed(seed)``. Its random
    values are not those the reference draws from ``PRNGKey(seed)``, so
    an untrained predictor keeps other tokens than the reference's
    untrained one; a carried-over predictor keeps the same. ``device``:
    where a lazily sized predictor lives and runs; None until
    ``QwenVLEngine`` sets it to the engine's device.
    """

    llm_side = True
    capture = "dart"  # only needs hidden states at the target layer
    name = "dynamic"

    def __init__(self, predictor: Predictor | None = None,
                 target_layer: int = 2, seed: int = 0, device=None):
        self.target_layer = target_layer
        self.seed = seed
        self.predictor = predictor  # lazily sized to the model
        self.device = device

    @torch.no_grad()
    def select(self, fastv_scores, key_l1, hidden_t, image_positions, budget):
        if self.predictor is None:
            gen = torch.Generator().manual_seed(self.seed)
            self.predictor = init_predictor(
                int(hidden_t.shape[-1]), gen, "cpu").to(self.device or "cpu")
        dev = self.predictor.down_kernel.device
        x = torch.as_tensor(np.asarray(hidden_t[image_positions], np.float32),
                            device=dev)[None]
        logits = predictor_forward(self.predictor, x)
        score = torch.log_softmax(logits, dim=-1)[0, :, 0].cpu().numpy()
        n = len(image_positions)
        k = max(1, int(n * budget))
        top = np.sort(np.argsort(-score, kind="stable")[:k])
        return image_positions[top]
