"""The arithmetic behind the metric files of ``benchmark/metrics/``: each
file's ``read(run)`` calls one of these (a metric split by a suffix reads
the same quantity in cells that move different end-to-end metrics).
Every reader returns None where its run has nothing to read."""

from __future__ import annotations

import math

import numpy as np

from benchmark import flops as F
from benchmark import serving

K1 = ("flash_images_prologue_kernel", "flash_wgmma_main_kernel")
K5 = ("decode_blocked_fwd_kernel",)


def _finished(run):
    return [s for s in run.due if s.result is not None]


def ttft_p90_ms(run):
    """90th percentile over every request due in the window of the time
    from its due time to its first token on the host; a request that
    never came counts as infinitely late."""
    if run.mix["kind"] != "open_loop" or not run.due:
        return None
    vals = [(s.t_first - (run.t0 + s.req.due)) * 1e3
            if s.result is not None else math.inf for s in run.due]
    v = serving.percentile(vals, 90)
    return v if math.isfinite(v) else None


def output_tok_s(run):
    """Tokens handed to clients inside the window over its length."""
    return serving.tokens_in(run.rec, run.window) / run.seconds


def queue_wait_ms_p50(run):
    """Median of first-token time less prefill time: the wait in the
    batcher's queue and the slot install."""
    done = _finished(run)
    if not done:
        return None
    return float(np.median([(s.result.first_token_seconds
                             - s.result.prefill_seconds) * 1e3
                            for s in done]))


def prefill_ms_p50(run):
    done = _finished(run)
    if not done:
        return None
    return float(np.median([s.result.prefill_seconds * 1e3 for s in done]))


def _in_window(run, names):
    a, b = run.window
    return [o for o in run.rec.ops if o[0] in names and a <= o[2] <= b]


def slot_occupancy(run):
    """Decode tokens handed out in the window over the slot-steps its
    dispatches ran, in percent."""
    steps = len(_in_window(run, ("dispatch",))) * run.chunk
    if steps == 0:
        return None
    toks = serving.tokens_in(run.rec, run.window, ("harvest",))
    return 100.0 * toks / (steps * run.n_slots)


def decode_step_ms(run):
    """Wall of the dispatch spans in the window over their decode steps."""
    ops = _in_window(run, ("dispatch",))
    if not ops:
        return None
    return 1e3 * sum(b - a for _, a, b, _ in ops) / (len(ops) * run.chunk)


def _dispatch_steps(info):
    """Live cache lengths of each step of one dispatch."""
    lens = np.asarray(info["lens"], np.int64)
    return [lens + s for s in range(info["chunk"])] if len(lens) else []


def _whole(run, name):
    """The operations called ``name`` that ran whole inside the traced
    window (host clock)."""
    a, b = run.traced
    return [o for o in run.rec.ops if o[0] == name and a <= o[1]
            and o[2] <= b]


def k1_roofline(run):
    """K1's least time over its device time, summed over the admissions
    that ran whole in the trace: the bound of each call from the
    request's own shapes."""
    if run.trace is None:
        return None
    dev = run.trace.kernel_s_by_span(K1)
    served = {o[3]["served"].req.rid: o[3]["served"]
              for o in _whole(run, "admit")}
    bound = spent = 0.0
    for span, sec in dev.items():
        name, _, rid = span.partition("#")
        if name != "admit" or int(rid) not in served:
            continue
        work = served[int(rid)].work
        bound += sum(F.bound_s(f, b) for f, b in work.k1_calls())
        spent += sec
    return 100.0 * bound / spent if spent > 0 else None


def k5_roofline(run):
    """K5's least time over its device time, summed over the dispatches
    in the trace: each step's bytes and operations from the live slots'
    cache lengths."""
    if run.trace is None:
        return None
    dev = run.trace.kernel_s_by_span(K5)
    infos = {o[3]["n"]: o[3] for o in _whole(run, "dispatch")}
    bound = spent = 0.0
    for span, sec in dev.items():
        name, _, n = span.partition("#")
        if name != "dispatch" or int(n) not in infos:
            continue
        for lens in _dispatch_steps(infos[int(n)]):
            _, nbytes, fl = F.decode_step(run.cfg, lens)
            bound += F.bound_s(fl, nbytes)
        spent += sec
    return 100.0 * bound / spent if spent > 0 else None


def mfu(run):
    """Model operations of the admissions and dispatches that ran whole
    inside the traced window, over the window at the card's bf16 peak,
    in percent."""
    if run.trace is None:
        return None
    a, b = run.traced
    total = sum(o[3]["served"].work.prefill_flops()
                for o in _whole(run, "admit"))
    total += sum(F.decode_step(run.cfg, lens)[0]
                 for o in _whole(run, "dispatch")
                 for lens in _dispatch_steps(o[3]))
    return 100.0 * total / ((b - a) * F.PEAK_FLOPS)


def idle_share(run):
    """Share of the traced window with no device operation, in percent."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
