"""The window's arithmetic, the trace's reading, and operations and
bytes against hand-worked cases."""

import math
from types import SimpleNamespace

import numpy as np

from benchmark import flops as F
from benchmark import profiling, readers, serving
from benchmark.tests import tiny


class _Res:
    def __init__(self, first, prefill):
        self.first_token_seconds, self.prefill_seconds = first, prefill


def _served(due, first, prefill=0.1):
    s = serving.Served(req=type("R", (), {"due": due})())
    if first is not None:
        s.t_first, s.result = first, _Res(first - due, prefill)
    return s


def test_ttft_p90_counts_a_stalled_request():
    mix = {"kind": "open_loop"}
    due = [_served(i * 0.1, i * 0.1 + 0.2) for i in range(19)]
    due.append(_served(2.0, 2.0 + 30.0))  # stalled: its first token late
    run = SimpleNamespace(mix=mix, due=due, t0=0.0)
    want = np.percentile([200.0] * 19 + [30000.0], 90)
    assert math.isclose(readers.ttft_p90_ms(run), want, rel_tol=1e-9)
    due[-1] = _served(2.0, None)  # never came: infinitely late
    due[-2] = _served(1.9, None)
    run = SimpleNamespace(mix=mix, due=due, t0=0.0)
    assert readers.ttft_p90_ms(run) is None


def test_tokens_over_the_window():
    rec = serving.Recorder()
    rec.emitted = [(0.5, 8, "harvest"), (1.0, 1, "admit"), (5.0, 8, "harvest"),
                   (10.0, 8, "harvest"), (10.5, 3, "harvest")]
    assert serving.tokens_in(rec, (1.0, 10.0)) == 17
    assert serving.tokens_in(rec, (1.0, 10.0), ("harvest",)) == 16
    run = SimpleNamespace(rec=rec, window=(1.0, 10.0), seconds=9.0)
    assert readers.output_tok_s(run) == 17 / 9.0
    rec.ops = [("dispatch", 2.0, 2.3, {}), ("dispatch", 9.0, 9.5, {}),
               ("dispatch", 10.0, 10.4, {})]
    run = SimpleNamespace(rec=rec, window=(1.0, 10.0), chunk=8, n_slots=2)
    assert math.isclose(readers.decode_step_ms(run), 1e3 * 0.8 / 16)
    assert math.isclose(readers.slot_occupancy(run), 100 * 16 / 32)


def test_union_and_idle_gaps():
    assert profiling.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    ev = [dict(cat="kernel", name="k", ts=0, dur=10, args={"correlation": 1}),
          dict(cat="kernel", name="k", ts=5, dur=10, args={"correlation": 2}),
          dict(cat="kernel", name="m", ts=40, dur=10,
               args={"correlation": 3}),
          dict(cat="cuda_runtime", name="launch", ts=1, tid=7,
               args={"correlation": 1}),
          dict(cat="cuda_runtime", name="launch", ts=2, tid=7,
               args={"correlation": 2}),
          dict(cat="cuda_runtime", name="launch", ts=30, tid=7,
               args={"correlation": 3}),
          dict(cat="user_annotation", name="bench.sync", ts=0, dur=0, tid=1)]
    served = serving.Served(req=type("R", (), {"rid": 4})())
    ops = [("admit", 0.0, 12e-6, {"served": served}),
           ("dispatch", 20e-6, 60e-6, {"n": 9}), ("prep", 0.0, 1.0, {})]
    busy_ms, by_name = profiling.device_busy(ev)
    assert busy_ms == 25 / 1e3 and by_name["k"] == [20 / 1e3, 2]
    import json
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump({"traceEvents": ev}, f)
    tr = profiling.Trace(f.name, 1e-4, ops, 0.0)
    assert tr.busy_s == 25e-6
    assert tr.kernel_s_by_span(("k",)) == {"admit#4": 20e-6}
    assert tr.kernel_s_by_span(("m",)) == {"dispatch#9": 10e-6}
    # the gap 15..40 has its midpoint 27.5 inside the dispatch span
    assert tr.breakdown()["idle_gaps"] == [["dispatch", 25e-6]]
    run = SimpleNamespace(trace=tr)
    assert math.isclose(readers.idle_share(run), 75.0)


def test_step_split():
    ev = [dict(cat="cpu_op", name="autograd::engine::evaluate_function: "
               "FlashAttentionFnBackward", ts=10, dur=10, tid=1),
          dict(cat="cpu_op", name="autograd::engine::evaluate_function: X",
               ts=20, dur=10, tid=1)]
    for c, ts in ((1, 5), (2, 12), (3, 25), (4, 40)):
        ev.append(dict(cat="cuda_runtime", ts=ts, tid=1,
                       args={"correlation": c}))
        ev.append(dict(cat="kernel", name="k", ts=ts, dur=1000,
                       args={"correlation": c}))
    out = profiling.step_split(ev)
    assert out == dict(forward=1.0, backward=2.0, mirror=1.0, update=1.0,
                       unmatched=0.0)


def test_flops_and_bytes_by_hand():
    assert F.causal_pairs(4) == 10
    # 2 x 3 merged tokens, windows of 2 x 2 merged tokens, 4 patches each:
    # windows of 4, 2 merged tokens -> 16^2 + 8^2 pairs
    assert F.window_pairs(2, 3, 2, 4) == 16 * 16 + 8 * 8
    fl, nb = F.attn_call(3, 5, 7, hq=4, hkv=2, d=8)
    assert fl == 4 * 8 * 4 * 7
    assert nb == 2 * 8 * (2 * 3 * 4 + 2 * 5 * 2)
    assert F.bound_s(989e12, 0) == 1.0 and F.bound_s(0, 3.35e12) == 1.0
    cfg = tiny.config("qwen25vl-3b-sel20")
    t = cfg["text_config"]
    # one decoder row, one pair a layer, the head on one row
    per_row = 2 * 96 * 24 * (2 * 4 + 2 * 2) + 6 * 96 * 192
    want = 2 * (per_row + 4 * 24 * 4 * 1) + 2 * 96 * t["vocab_size"]
    assert F.decoder_flops(t, 1, 1, 1) == want
    fl, k5_bytes, k5_fl = F.decode_step(cfg, [10, 20])
    assert k5_bytes == 2 * 2 * 24 * (2 * 2 * 30 + 2 * 4 * 2)
    assert k5_fl == 2 * 4 * 24 * 4 * 30
    w = F.Request(cfg, (1, 10, 6), text=20)
    assert (w.patches, w.n, w.k, w.valid) == (60, 15, 3, 23)
    # one full-attention layer over the 60 patches, 4 heads of 16
    assert w.vision_calls() == [(4 * 16 * 4 * 3600, 2 * 16 * 4 * 4 * 60)]
    assert len(w.k1_calls()) == 1 + t["num_hidden_layers"]
