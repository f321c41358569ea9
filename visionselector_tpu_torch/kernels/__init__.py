"""Attention (CUDA kernels + plain PyTorch versions), the weight-only
quantized product for decode rows (``wq_matmul``) and top-k."""
