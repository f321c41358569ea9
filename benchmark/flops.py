"""Operations and bytes of the work the benchmark hands the program,
computed from the shapes of its own inputs, and the card's peaks.

A product of an [m, k] by a [k, n] matrix is 2 m k n operations. An
attention over P (query, key) pairs of one head of width d is 4 d P: 2 d
for the scores and 2 d for the weighted sum. Roofline bytes count each
input read once and each output written once, in bf16.

Peaks: NVIDIA's data sheet for the H100 SXM at its full 700 W, dense
bf16 989 TFLOP/s and 3.35 TB/s of HBM.
"""

from __future__ import annotations

import numpy as np

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card needs for this work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def window_pairs(mh: int, mw: int, ws: int, unit: int) -> int:
    """(query, key) pairs of one image's window layers: each ws x ws
    window of merged tokens (edge windows partial), ``unit`` patches a
    merged token, attends within itself."""
    total = 0
    for r in range(0, mh, ws):
        for c in range(0, mw, ws):
            n = (min(ws, mh - r) * min(ws, mw - c)) * unit
            total += n * n
    return total


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def attn_call(rows_q: int, rows_kv: int, pairs: int, hq: int, hkv: int,
              d: int):
    """(operations, bytes) of one attention call: q and out of rows_q rows
    and hq heads, k and v of rows_kv rows and hkv heads."""
    flops = 4 * d * hq * pairs
    nbytes = BF16 * d * (2 * rows_q * hq + 2 * rows_kv * hkv)
    return flops, nbytes


def decoder_flops(t: dict, rows: int, pairs: int, head_rows: int) -> float:
    """A decoder pass over ``rows`` tokens: the layers' products, the
    attention over ``pairs`` (query, key) pairs a layer, and the head on
    ``head_rows`` rows."""
    h, hq, hkv, dh = (t["hidden_size"], t["num_attention_heads"],
                      t["num_key_value_heads"], t["head_dim"])
    per_row = 2 * h * dh * (2 * hq + 2 * hkv) + 6 * h * t["intermediate_size"]
    layer = rows * per_row + 4 * dh * hq * pairs
    return t["num_hidden_layers"] * layer + 2 * head_rows * h * t["vocab_size"]


class Request:
    """The model work of one served image request: its sizes, as the
    benchmark made them (``patches`` of a (gh, gw) grid, ``text`` tokens
    besides the image, ``k`` kept vision tokens)."""

    def __init__(self, cfg: dict, grid, text: int):
        self.cfg = cfg
        _, gh, gw = grid
        v = cfg["vision_config"]
        self.m = v["spatial_merge_size"]
        self.gh, self.gw = gh, gw
        self.patches = gh * gw
        self.n = self.patches // (self.m * self.m)
        self.k = max(1, int(self.n * cfg["selector"]["budget"]))
        self.text = text
        self.valid = text + self.k  # the compacted prompt

    # -- the vision tower -------------------------------------------------

    def vision_calls(self):
        """[(operations, bytes)] of the tower's K1 (flash) calls: the
        Qwen ViT's full-attention layers, or every RICE block over the
        image and its CLS row."""
        v = self.cfg["vision_config"]
        heads, d = v["num_heads"], v["hidden_size"] // v["num_heads"]
        if self.cfg["family"] == "qwen25vl":
            p, n_calls = self.patches, len(v["fullatt_block_indexes"])
        else:
            p, n_calls = self.patches + 1, v["depth"]
        return [attn_call(p, p, p * p, heads, heads, d)] * n_calls

    def vision_flops(self) -> float:
        v = self.cfg["vision_config"]
        d, i = v["hidden_size"], v["intermediate_size"]
        heads, hd = v["num_heads"], v["hidden_size"] // v["num_heads"]
        unit = self.m * self.m
        patch_dim = v["in_channels"] * v["temporal_patch_size"] \
            * v["patch_size"] ** 2
        if self.cfg["family"] == "qwen25vl":
            p = self.patches
            n_full = len(v["fullatt_block_indexes"])
            ws = v["window_size"] // self.m // v["patch_size"]
            wp = window_pairs(self.gh // self.m, self.gw // self.m, ws, unit)
            pairs = n_full * p * p + (v["depth"] - n_full) * wp
            mlp = 6 * d * i  # gate, up, down
            out = v["out_hidden_size"]
        else:
            p = self.patches + 1
            pairs = v["depth"] * p * p
            mlp = 4 * d * i  # fc1, fc2
            out = v["text_hidden_size"]
        blocks = v["depth"] * p * (2 * d * 3 * d + 2 * d * d + mlp)
        merged = self.n
        merger = 2 * merged * (unit * d) ** 2 + 2 * merged * unit * d * out
        return (2 * self.patches * patch_dim * d + blocks
                + 4 * hd * heads * pairs + merger)

    def scorer_flops(self) -> float:
        s = self.cfg["selector"]
        d = (self.cfg["vision_config"].get("out_hidden_size")
             or self.cfg["vision_config"]["text_hidden_size"])
        return 2 * 2 * self.n * d * s["hidden_dim"]

    # -- the decoder ------------------------------------------------------

    def prefill_call(self):
        """(operations, bytes) of one layer's causal K1 call over the
        compacted prompt."""
        t = self.cfg["text_config"]
        return attn_call(self.valid, self.valid, causal_pairs(self.valid),
                         t["num_attention_heads"], t["num_key_value_heads"],
                         t["head_dim"])

    def prefill_flops(self) -> float:
        """The whole prefill: tower, scorer, and the decoder over the
        compacted prompt with the head on its last row."""
        t = self.cfg["text_config"]
        return (self.vision_flops() + self.scorer_flops()
                + decoder_flops(t, self.valid, causal_pairs(self.valid), 1))

    def k1_calls(self):
        """Every K1 call of the prefill: the tower's and one a decoder
        layer."""
        t = self.cfg["text_config"]
        return self.vision_calls() + [self.prefill_call()] \
            * t["num_hidden_layers"]


def decode_step(cfg: dict, lengths) -> tuple:
    """(operations, K5's bytes, K5's operations) of one decode step of
    live slots whose caches hold ``lengths`` rows each, the new row
    included. K5 reads each slot's k and v and writes one row of output a
    layer."""
    t = cfg["text_config"]
    hq, hkv, dh, L = (t["num_attention_heads"], t["num_key_value_heads"],
                      t["head_dim"], t["num_hidden_layers"])
    lengths = np.asarray(lengths, np.int64)
    flops = decoder_flops(t, len(lengths), int(lengths.sum()), len(lengths))
    k5_bytes = L * BF16 * dh * (2 * hkv * lengths.sum()
                                + 2 * hq * len(lengths))
    k5_flops = L * 4 * dh * hq * lengths.sum()
    return float(flops), float(k5_bytes), float(k5_flops)
