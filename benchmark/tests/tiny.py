"""Tiny versions of the cells' configurations and mixes, for runs of the
whole harness on the CPU (float32 weights; the program takes its plain
PyTorch paths on CPU tensors)."""

from __future__ import annotations

import copy

from benchmark import models, traffic

SIZES = [[56, 56], [112, 84], [84, 140]]


def config(name: str) -> dict:
    cfg = copy.deepcopy(models.load_config(name))
    cfg["dtype"] = "float32"
    v, t = cfg["vision_config"], cfg["text_config"]
    v.update(depth=2, hidden_size=64, intermediate_size=128, num_heads=4)
    if cfg["family"] == "qwen25vl":
        v.update(out_hidden_size=96, fullatt_block_indexes=[1],
                 window_size=56)
        t.update(mrope_section=[4, 4, 4])
    else:
        v.update(text_hidden_size=96)
    t.update(hidden_size=96, intermediate_size=192, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=24)
    cfg["selector"]["hidden_dim"] = 48
    cfg["processor"] = {"min_pixels": 3136, "max_pixels": 140 * 140}
    # larger weights than the full-size 0.02: at these widths attention is
    # otherwise near-uniform and a wrong context barely moves a logit
    cfg["init"] = dict(cfg["init"], std=0.15, jitter=0.1)
    return models.resolve(cfg)


def mix(name: str, **over) -> dict:
    m = copy.deepcopy(traffic.load_mix(name))
    m.update(image_sizes=SIZES, image_variants=2, lead_in_s=0.5, drain_s=60,
             trace_s=0.5)
    if m["kind"] == "open_loop":
        m.update(rate_per_s=4.0, answer_len=[3, 9])
        m["batcher"] = {"n_slots": 4, "t_max": 512, "chunk": 4}
    else:
        m.update(clients=5, stream=400, answer_len=[6, 14])
        m["batcher"] = {"n_slots": 4, "t_max": 512, "chunk": 4}
    # float32 on both sides: the program's readings are rounding alone
    m["check"] = dict(m["check"], tokens=40, max_requests=5,
                      limits={"layout": 0, "select_gap": 1e-3,
                              "logit_gap": 1e-3})
    m.update(over)
    return m
