"""The traced run: a ``torch.profiler`` window and what the benchmark
reads from its trace.

``device_busy`` and ``step_split`` are frozen copies of the helpers of
the same names in the repository's ``chip_smoke.py``: the union of the
device's kernel, copy and memset intervals, and a training step's device
time split by the host code that launched it.
"""

from __future__ import annotations

import bisect
import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BREAKDOWN_TOP = 10


def union_s(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def merged(spans) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_busy(events):
    """(busy ms, {kernel name: [ms, count]}) of a chrome trace's events:
    busy is the union of the device's kernel, copy and memset intervals."""
    spans, by_name = [], {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            acc = by_name.setdefault(e["name"], [0.0, 0])
            acc[0] += float(e["dur"]) / 1e3
            acc[1] += 1
    return union_s(spans) / 1e3, by_name


def step_split(events, mirror="FlashAttentionFnBackward"):
    """Device ms of a training step's trace by the host code that launched
    each kernel, copy or memset (matched by its correlation id):
    "forward" before the autograd engine's first node, "backward" inside
    its nodes ("mirror": inside the ``mirror`` nodes, a part of
    "backward"), "update" after its last. None when the trace holds no
    autograd node or no device event."""
    nodes, mirrors, launches, device = [], [], {}, []
    for e in events:
        cat, name, args = e.get("cat"), e.get("name", ""), e.get("args") or {}
        if cat == "cpu_op" and name.startswith(
                "autograd::engine::evaluate_function"):
            span = (e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            nodes.append(span)
            if name.endswith(mirror):
                mirrors.append(span)
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e["tid"], float(e["ts"]))
        elif cat in DEVICE_CATS and "dur" in e:
            device.append((args.get("correlation"), float(e["dur"]) / 1e3))
    if not nodes or not device:
        return None
    b0, b1 = min(n[1] for n in nodes), max(n[2] for n in nodes)
    out = dict.fromkeys(("forward", "backward", "mirror", "update",
                         "unmatched"), 0.0)
    for corr, ms in device:
        if corr not in launches:
            out["unmatched"] += ms
            continue
        tid, ts = launches[corr]
        if ts < b0:
            out["forward"] += ms
        elif ts <= b1:
            out["backward"] += ms
            if any(t == tid and a <= ts <= b for t, a, b in mirrors):
                out["mirror"] += ms
        else:
            out["update"] += ms
    return out


class Window:
    """A profiler window opened and closed by ``tick`` (called from the
    main thread: the profiler refuses to start on another) first after
    ``start_at`` and after ``stop_at``. The device tracing is set up at
    construction (it takes seconds, so it belongs to set-up); opening the
    window only starts the recording."""

    def __init__(self, start_at: float, stop_at: float, path: str):
        self.start_at, self.stop_at, self.path = start_at, stop_at, path
        self.stopped = None
        self.prof = None
        self.start_cost = self.stop_cost = 0.0
        self.ready = new_profile()
        self.ready.prepare_trace()
        self.t_start = self.t_stop = None
        self.done = False

    def tick(self):
        now = time.perf_counter()
        if self.prof is None and not self.done and now >= self.start_at:
            self._start()
        elif self.prof is not None and \
                now >= self.t_start + self.stop_at - self.start_at:
            self._stop()

    def _start(self):
        from torch.profiler import record_function

        t = time.perf_counter()
        self.prof, self.ready = self.ready, None
        self.prof.start_trace()
        # one range whose trace time is known on the host clock: the
        # trace's times of the host's spans follow from it
        with record_function("bench.sync"):
            self.t_sync = time.perf_counter()
        self.t_start = time.perf_counter()
        self.start_cost = self.t_start - t

    def _stop(self):
        import torch

        torch.cuda.synchronize()  # the window's device work is recorded
        self.t_stop = time.perf_counter()
        self.prof.stop_trace()
        self.stop_cost = time.perf_counter() - self.t_stop
        self.stopped, self.prof = self.prof, None
        self.done = True

    def close(self):
        """Stop the profiler if it is still recording."""
        if self.prof is not None:
            self._stop()

    def read(self, ops) -> "Trace":
        """Export the trace (after the run's window) and read it, with the
        host's spans ``ops`` [(name, t0, t1, info)] placed on its clock."""
        self.stopped.export_chrome_trace(self.path)
        self.stopped = None
        return Trace(self.path, self.t_stop - self.t_start, ops, self.t_sync)


def new_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])




def span_name(name: str, info: dict) -> str:
    if name == "admit":
        return f"admit#{info['served'].req.rid}"
    if name == "dispatch":
        return f"dispatch#{info['n']}"
    return name


class Trace:
    """What the benchmark reads from one exported trace. The host's spans
    (the batcher's operations, from the benchmark's own records) are
    placed on the trace's clock through the ``bench.sync`` range, and a
    device operation belongs to the span during which the host launched
    it."""

    def __init__(self, path: str, window_s: float, ops=(), t_sync=None):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        self.window_s = window_s
        busy_ms, self.by_name = device_busy(events)
        self.busy_s = busy_ms / 1e3
        self.device = []  # (ts, end, name, correlation)
        launches, self.spans, sync = {}, [], None
        for e in events:
            cat, args = e.get("cat"), e.get("args") or {}
            if cat in DEVICE_CATS and "dur" in e:
                ts = float(e["ts"])
                self.device.append((ts, ts + float(e["dur"]), e["name"],
                                    args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (e["tid"], float(e["ts"]))
            elif e.get("name") == "bench.sync" and "dur" in e:
                sync = float(e["ts"]) + float(e["dur"]) / 2
        self.launch = launches
        if sync is not None:
            for name, t0, t1, info in ops:
                if name in ("admit", "dispatch", "harvest"):
                    self.spans.append(((t0 - t_sync) * 1e6 + sync,
                                       (t1 - t_sync) * 1e6 + sync,
                                       span_name(name, info)))
        self.spans.sort()
        self.starts = [s[0] for s in self.spans]

    def span_at(self, ts: float):
        """The host span (they do not overlap) holding trace time ``ts``,
        or None."""
        i = bisect.bisect_right(self.starts, ts) - 1
        if i >= 0 and ts <= self.spans[i][1]:
            return self.spans[i][2]
        return None

    def span_of(self, corr):
        """The host span during which device event ``corr`` was
        launched, or None."""
        if corr not in self.launch:
            return None
        return self.span_at(self.launch[corr][1])

    def kernel_s_by_span(self, words) -> dict:
        """{span name: device seconds of kernels whose name holds one of
        ``words``, launched inside that span}."""
        out = {}
        for ts, end, name, corr in self.device:
            if any(w in name for w in words):
                span = self.span_of(corr)
                if span is not None:
                    out[span] = out.get(span, 0.0) + (end - ts) / 1e6
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the batcher's operation the host was in at each gap's
        midpoint ("other": between operations: the batcher's loop, or
        waiting for work)."""
        ops = sorted(((n, ms / 1e3) for n, (ms, _) in self.by_name.items()),
                     key=lambda x: -x[1])[:BREAKDOWN_TOP]
        busy = merged((a, b) for a, b, _, _ in self.device)
        gaps = {}
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            name = (self.span_at((e0 + s1) / 2) or "other").split("#")[0]
            gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e6
        idle = sorted(gaps.items(), key=lambda x: -x[1])[:BREAKDOWN_TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}
