"""Training-free token-compression baselines (the reference's parity
suite), as ``visionselector_tpu.selector.baselines``.

Each baseline is a selection strategy: given the merged vision tokens (and
last-ViT-block attention statistics), or for the LLM-side ones the
decoder's statistics at a target layer, it returns the kept token indices
and optionally replacement embeddings. The engine
(``models.qwen25vl.model.QwenVLEngine(strategy=...)``) runs them in its
"score -> select -> compact -> prefill" pipeline. Selection runs on the
host in numpy (the reference's own split); the Dynamic-Qwen predictor is
a small PyTorch module.
"""

from __future__ import annotations

from typing import Callable, Dict

from visionselector_tpu_torch.selector.baselines.dynamic import DynamicSelect
from visionselector_tpu_torch.selector.baselines.llm_side import DART, FastV
from visionselector_tpu_torch.selector.baselines.methods import (
    DivPrune,
    HoloV,
    PruMergePlus,
    RandomSelect,
    VisionZip,
)

_REGISTRY: Dict[str, Callable] = {
    "visionzip": VisionZip,
    "prumerge_plus": PruMergePlus,
    "divprune": DivPrune,
    "holov": HoloV,
    "random": RandomSelect,
    "fastv": FastV,
    "dart": DART,
    "dynamic": DynamicSelect,
}


def get_baseline(name: str, **kwargs):
    if name not in _REGISTRY:
        raise KeyError(f"unknown baseline {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_baselines():
    return sorted(_REGISTRY)
