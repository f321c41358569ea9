"""Load for the serving cells: an open loop (clients due at Poisson
arrival times) and a closed loop (a fixed number of clients, each sending
its next request when the last one returns), both through the program's
``ContinuousBatcher``.

The benchmark records its own spans around the batcher's operations by
wrapping methods of the batcher instance (the program is not edited):
``admit`` (host prep, the tower, selection, compaction, the decoder's
prefill, the slot install), ``dispatch`` (a decode chunk, ended by its
host read) and ``harvest`` (handing the chunk's tokens out); the clients
record ``prep`` (the processor) themselves. With ``--trace 1`` the main
thread opens and closes the profiler window (the profiler starts on no
other thread), and the readers count only the operations that lie whole
in it.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import numpy as np

from benchmark import flops as F
from benchmark import traffic

NO_EOS = (-1,)  # no token ends an answer: every request runs to its budget


@dataclasses.dataclass
class Served:
    req: traffic.Request
    ids: np.ndarray = None
    pixels: np.ndarray = None
    grid: tuple = None
    t_submit: float = 0.0
    t_first: float = 0.0  # the first token reached the host
    result: object = None
    error: str = None
    work: F.Request = None


class Recorder:
    """Spans and counters of one run, kept in memory."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ops = []  # (name, t0, t1, info)
        self.emitted = []  # (t, tokens, "admit" | "harvest") handed out
        self.trace = None  # profiling.Window while tracing

    def add(self, name, t0, t1, info=None):
        with self.lock:
            self.ops.append((name, t0, t1, info or {}))


def instrument(bat, rec: Recorder, cfg: dict, rid_of):
    """Wrap the batcher instance's admission, dispatch and harvest so each
    records a span; the dispatch notes the live slots' cache lengths (for
    the decode kernel's bound and the step's operations), the harvest the
    tokens it hands out."""
    op, dispatch, harvest = bat._op, bat._dispatch, bat._harvest
    chunk = bat.chunk

    def wrapped_op(name, *args):
        t0 = time.perf_counter()
        info = {}
        if name == "admit":
            info["served"] = rid_of(args[0])
            out = op(name, *args)
        else:  # a dispatch: its spans are ``dispatch`` and ``harvest``
            return op(name, *args)
        t1 = time.perf_counter()
        rec.add(name, t0, t1, info)
        if bat.slots[args[1]] is not None:
            rec.emitted.append((t1, 1, "admit"))  # the first token
        return out

    def wrapped_dispatch():
        lens = []
        for slot in bat.slots:
            if slot is not None:
                valid = rid_of(slot.item).work.valid
                lens.append(valid + len(slot.tokens))
        t0 = time.perf_counter()
        n = len(rec.ops)
        out = dispatch()
        rec.add("dispatch", t0, time.perf_counter(),
                dict(lens=lens, chunk=chunk, n=n))
        return out

    def wrapped_harvest(toks):
        held = [s for s in bat.slots if s is not None]
        before = sum(len(s.tokens) for s in held)
        t0 = time.perf_counter()
        harvest(toks)
        t1 = time.perf_counter()
        rec.emitted.append((t1, sum(len(s.tokens) for s in held) - before,
                            "harvest"))
        rec.add("harvest", t0, t1)

    bat._op = wrapped_op
    bat._dispatch = wrapped_dispatch
    bat._harvest = wrapped_harvest


def prepare(served: Served, mix: dict, cfg: dict):
    """The client's host work before it submits: the processor (resize,
    normalise, patches) and the chat-formatted ids."""
    from visionselector_tpu_torch.preprocess.image import preprocess_image

    v, proc = cfg["vision_config"], cfg["processor"]
    px, grid = preprocess_image(
        served.req.image, min_pixels=proc["min_pixels"],
        max_pixels=proc["max_pixels"], patch_size=v["patch_size"],
        temporal_patch_size=v["temporal_patch_size"],
        merge_size=v["spatial_merge_size"])
    grid = tuple(int(x) for x in np.asarray(grid)[0])
    n = grid[0] * grid[1] * grid[2] // v["spatial_merge_size"] ** 2
    served.pixels, served.grid = px, grid
    served.ids = traffic.prompt_ids(mix, cfg, n, served.req.question)
    served.work = F.Request(cfg, grid, len(served.ids) - n)


def client(bat, served: Served, mix: dict, cfg: dict, rec: Recorder,
           registry: dict):
    """Prepare and submit one request; record its times."""
    try:
        t0 = time.perf_counter()
        prepare(served, mix, cfg)
        rec.add("prep", t0, time.perf_counter())
        registry[id(served.ids)] = served
        served.t_submit = time.perf_counter()
        res = bat.submit(dict(input_ids=served.ids,
                              pixel_values=served.pixels,
                              grid_thw=np.asarray([served.grid])),
                         max_new_tokens=served.req.max_new,
                         eos_token_ids=NO_EOS)
        served.t_first = served.t_submit + res.first_token_seconds
        served.result = res
    except Exception as e:  # noqa: BLE001 - counted as failed
        served.error = repr(e)


def make_batcher(engine, mix: dict, cfg: dict, rec: Recorder):
    """The batcher of the mix's sizes, instrumented; returns (batcher,
    registry: id(ids) -> Served)."""
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
    )

    b = mix["batcher"]
    bat = ContinuousBatcher(engine, n_slots=b["n_slots"], t_max=b["t_max"],
                            chunk=b["chunk"])
    registry = {}
    instrument(bat, rec, cfg,
               lambda item: registry[id(item["request"]["input_ids"])])
    return bat, registry


def run_open(bat, registry, reqs, mix, cfg, rec, lead, seconds, t0):
    """Send each request at its due time (``t0`` + due) from a client
    thread of its own, up to the window's end (a sender thread; the main
    thread keeps the profiler window); wait for every request due in the
    window, at most ``drain_s`` past the close. Returns (served, window
    (open, close), the sender's lateness [s] per request)."""
    served = [Served(r) for r in reqs]
    threads, late = [], []

    def send():
        for s in served:
            due = t0 + s.req.due
            time.sleep(max(0.0, due - time.perf_counter()))
            late.append(time.perf_counter() - due)
            th = threading.Thread(target=client, daemon=True,
                                  args=(bat, s, mix, cfg, rec, registry))
            th.start()
            threads.append(th)

    sender = threading.Thread(target=send, daemon=True)
    sender.start()
    close = t0 + lead + seconds
    join_all([sender], close + 1.0, rec.trace)
    join_all(threads, close + mix["drain_s"], rec.trace)
    return served, (t0 + lead, close), late


def join_all(threads, deadline: float, win=None):
    """Join ``threads`` until ``deadline``, opening and closing the
    profiler window ``win`` on the way (the main thread's job)."""
    for th in threads:
        while th.is_alive() and time.perf_counter() < deadline:
            if win is not None:
                win.tick()
            th.join(timeout=0.02)


def run_closed(bat, registry, stream, mix, cfg, rec, lead, seconds, t0):
    """``clients`` threads, each sending the stream's next request when its
    last returns, until the window closes; then wait for those in flight,
    at most ``drain_s``. Returns (served, window (open, close))."""
    close = t0 + lead + seconds
    lock = threading.Lock()
    served, counter = [], itertools.count()

    def loop():
        while time.perf_counter() < close:
            with lock:
                j = next(counter)
                s = Served(stream[j])
                served.append(s)
            client(bat, s, mix, cfg, rec, registry)

    threads = [threading.Thread(target=loop, daemon=True)
               for _ in range(mix["clients"])]
    for th in threads:
        th.start()
    join_all(threads, close + mix["drain_s"], rec.trace)
    return served, (t0 + lead, close)


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def tokens_in(rec: Recorder, window, kinds=("admit", "harvest")) -> int:
    """Tokens handed to clients inside the window: a chunk's tokens count
    when its harvest ends, a first token when its admission ends."""
    a, b = window
    return sum(n for t, n, k in rec.emitted if a <= t <= b and k in kinds)
