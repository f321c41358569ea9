"""VisionSelector on PyTorch and CUDA: Qwen2.5-VL selector inference and
continuous-batching serving.

A port of ``visionselector_tpu`` (JAX, the reference) with the same module
layout: ``core`` (configs), ``preprocess`` (host index arrays), ``kernels``
(attention: hand-written CUDA kernels for Hopper plus their plain PyTorch
versions; top-k), ``selector`` (LIS scorer, compaction), ``models.qwen25vl``
(ViT, decoder, engine with sampling, continuous batcher, weights) and
``api`` (the predict CLI).

Importing this package loads ``torch`` and ``numpy`` only. The CUDA kernels
are compiled with ``nvcc`` the first time a CUDA tensor reaches them
(``kernels/_build.py``); CPU tensors take the plain PyTorch versions.
"""

__version__ = "0.1.0"
