"""Shared by the tests/test_torch_*.py parity tests: a parameter tree in
the JAX package's ``init_params`` layout, made with numpy from a seed
(same init rule: norm scales ones, biases zeros, other tensors normal with
std 0.02, the scorer with ``scorer_std``). Building it from
``jax.eval_shape`` skips the seconds of XLA compiles a real
``init_params`` costs on the CPU."""

import jax
import numpy as np


def jax_param_tree(cfg, seed: int, scorer_std: float = 1e-4) -> dict:
    from visionselector_tpu.models.qwen25vl.model import init_params

    shapes = jax.eval_shape(lambda k: init_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("_scale']"):
            return np.ones(leaf.shape, np.float32)
        if name.endswith("_bias']"):
            return np.zeros(leaf.shape, np.float32)
        std = scorer_std if name.startswith("['scorer']") else 0.02
        return (rng.randn(*leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_ov_param_tree(cfg, seed: int, scorer_std: float = 1e-4) -> dict:
    """``jax_param_tree`` for the OV family (``init_ov_params`` layout):
    the same rule, with the CLS rotary row ``class_pos_emb`` at std 1 (the
    reference's init), so that its learned rotation is not near the
    identity."""
    from visionselector_tpu.models.llava_ov15.model import init_ov_params

    shapes = jax.eval_shape(lambda k: init_ov_params(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("_scale']"):
            return np.ones(leaf.shape, np.float32)
        if name.endswith("_bias']"):
            return np.zeros(leaf.shape, np.float32)
        std = (scorer_std if name.startswith("['scorer']")
               else 1.0 if name.endswith("['class_pos_emb']") else 0.02)
        return (rng.randn(*leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)
