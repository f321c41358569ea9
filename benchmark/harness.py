"""One run of one cell: set-up, the measured window, the metrics, the
check against the plain reference, the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration (``benchmark/configs/<config>.json``) and traffic
mix (``benchmark/mixes/<traffic>.json``); every metric is read by
``benchmark/metrics/<metric name>.py``, whose ``read(run)`` returns a
number or None (nothing to read in this run).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "visionselector_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from /proc; 0 where there is
    none)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name only begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded: the run gives no result."""


def check_imports(stage: str):
    """Raise ForbiddenImport if JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"forbidden modules loaded {stage}: {found}")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: with ``trace`` the per-layer
    ones, else the end-to-end ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


def reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_caches():
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


class Setup:
    """The parts of set-up, in seconds, in the order they ran."""

    def __init__(self, age: float):
        self.parts = {"process": age}
        self.build_s = 0.0  # of "library": the kernels' nvcc build
        self.t = time.perf_counter()

    def mark(self, name: str):
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self.t
        self.t = now

    def total(self) -> float:
        return sum(self.parts.values())


def device_info(torch, n: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(n)))}


def backlog(due: list, t0: float, window) -> dict:
    """How far an open loop fell behind: requests due in the window still
    without a first token at its close, and the median time to first
    token of the requests due in its first and second halves."""
    mid = (window[0] + window[1]) / 2
    late = sum(1 for s in due if s.result is None or s.t_first > window[1])
    halves = ([], [])
    for s in due:
        if s.result is not None:
            halves[t0 + s.req.due >= mid].append(s.t_first - t0 - s.req.due)
    p50 = [1e3 * sorted(h)[len(h) // 2] if h else None for h in halves]
    return {"waiting_at_close": late, "ttft_p50_ms_halves": p50}


def span_means(ops: list, window) -> dict:
    """Mean milliseconds of each kind of span that began in the window
    (host speed, for reading a run's spread beside its metrics)."""
    sums = {}
    for name, a, b, _ in ops:
        if window[0] <= a < window[1]:
            n, t = sums.get(name, (0, 0.0))
            sums[name] = (n + 1, t + b - a)
    return {f"{k}_ms_mean": 1e3 * t / n for k, (n, t) in sorted(sums.items())}


def serve_cell(cell: dict, seed: int, seconds: float, trace: bool,
               setup: Setup, device="cuda", cfg=None, mix=None,
               fault=None, control: bool = False) -> dict:
    """A serving cell: set-up, the window, the metrics, the check.
    ``cfg`` / ``mix`` (dicts) replace the named files (the CPU tests run
    tiny ones); ``fault(batcher)`` plants a fault under the timed path
    (the tests'); ``control`` also judges the fp8 control on the same
    requests (the calibration's)."""
    import numpy as np
    import torch

    from benchmark import judge, models, profiling, serving, traffic

    setup.mark("import")
    cfg = cfg or models.load_config(cell["config"])
    mix = mix or traffic.load_mix(cell["traffic"])
    if device == "cuda":
        from visionselector_tpu_torch.kernels import _build

        _build.load()
        setup.mark("library")
        setup.build_s = _build.BUILD_SECONDS
    weights = models.make_weights(cfg, seed, device)
    _, engine = models.build_program(cfg, weights, device)
    del weights
    if device == "cuda":
        torch.cuda.empty_cache()
    setup.mark("weights")
    lead = mix["lead_in_s"]
    pix = traffic.images(mix, seed)
    if mix["kind"] == "open_loop":
        stream = traffic.open_loop(mix, seed, seconds, pix)
    else:
        stream = traffic.requests(mix, seed, mix["stream"], pix)
    warm = traffic.requests(mix, seed + 1, len(pix), pix)
    for j, r in enumerate(warm):  # one of each image size
        r.image = pix[j][0]
        r.max_new = mix["batcher"]["chunk"] + 2
    setup.mark("traffic")
    rec = serving.Recorder()
    bat, registry = serving.make_batcher(engine, mix, cfg, rec)
    threads = [threading.Thread(
        target=serving.client, args=(bat, serving.Served(r), mix, cfg, rec,
                                     registry)) for r in warm]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    rec.ops.clear()
    rec.emitted.clear()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if fault is not None:
        fault(bat)
    win = None
    if trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        win = profiling.Window(0.0, mix["trace_s"], path)
    setup.mark("warmup")
    check_imports("after set-up")
    t0 = time.perf_counter() + 0.01
    setup_s = setup.total()
    if win is not None:
        # the end of the measured window: stopping the profiler holds the
        # process for seconds while it gathers the trace, which then
        # delays no request due in the window
        win.start_at = t0 + lead + seconds - mix["trace_s"]
        win.stop_at = win.start_at + mix["trace_s"]
        rec.trace = win
    late = []
    if mix["kind"] == "open_loop":
        served, window, late = serving.run_open(
            bat, registry, stream, mix, cfg, rec, lead, seconds, t0)
        due = [s for s in served
               if window[0] <= t0 + s.req.due < window[1]]
    else:
        served, window = serving.run_closed(
            bat, registry, stream, mix, cfg, rec, lead, seconds, t0)
        due = served
    info = device_info(torch, 1) if device == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    tr, notes_trace = None, {}
    if win is not None:
        win.close()
        rec.trace = None
        if win.stopped is not None:
            tr = win.read(rec.ops)
            info["busy_s"] = tr.busy_s
            info["window_s"] = tr.window_s
            notes_trace = {"trace_start_s": win.start_cost,
                           "trace_stop_s": win.stop_cost,
                           "traced": [win.t_start - t0, win.t_stop - t0]}
    bat.shutdown()
    leaked = forbidden_modules()
    run = SimpleNamespace(cfg=cfg, mix=mix, rec=rec, served=served, due=due,
              window=window, seconds=seconds, trace=tr, setup_s=setup_s,
              t0=t0, n_slots=mix["batcher"]["n_slots"],
              traced=(win.t_start, win.t_stop) if tr is not None else None,
              chunk=mix["batcher"]["chunk"])
    bench = manifest()
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for s in due if s.result is None)
    del bat, engine, registry
    gc.collect()  # the instrumented batcher's closures hold it in a cycle
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = judge.judge(cfg, mix, served, seed, device)
    ok, rows = judge.verdict(numbers, mix["check"]["limits"])
    low = (judge.judge(cfg, mix, served, seed, device, control=True)
           if control else None)
    result = {
        "correct": bool(ok and failed == 0 and not leaked),
        "attempted": len(due), "failed": failed, "metrics": metrics,
        "device": info}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    notes = {"setup_parts_s": setup.parts, "setup_s": setup_s,
             "build_s": setup.build_s,
             "check_s": time.perf_counter() - t_check,
             "judged_requests": numbers["requests"],
             "judged_tokens": numbers["tokens"], "forbidden": leaked,
             "errors": [s.error for s in served if s.error][:3],
             "late_ms_max": 1e3 * max(late) if late else 0.0,
             "late_ms_p99": 1e3 * float(np.percentile(late, 99))
             if late else 0.0,
             "window": [window[0] - t0, window[1] - t0]}
    notes.update(span_means(rec.ops, window))
    notes.update(notes_trace)
    if mix["kind"] == "open_loop":
        notes.update(backlog(due, t0, window))
    return {"result": result, "notes": notes, "numbers": numbers,
            "control": low}
