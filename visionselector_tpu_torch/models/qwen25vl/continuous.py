"""Continuous batching: requests join and leave the decode loop mid-flight.

Counterpart of ``visionselector_tpu.models.qwen25vl.continuous``. The engine
keeps a pool of S decode slots on the device — one pre-allocated
[L, S, T_max, H_kv, D] KV buffer, bf16 or int8 with per-row scales — and
advances ALL live slots ``chunk`` steps per dispatch; at every chunk
boundary finished slots are freed and queued requests are admitted into
free slots. Short requests never wait for long ones, and a request admitted
mid-decode starts after at most one chunk.

- The chunk is a Python loop of ``chunk`` calls to ``lm_decode_step`` over
  the pool, written in place; decode attention is the decode kernel on the
  card, which reads only each slot's live prefix of the pool.
- EOS detection is on the host, per slot (requests may use different stop
  tokens); a slot that stops mid-chunk wastes at most chunk - 1 steps.
- Empty slots still step (their lanes compute garbage) but their lengths
  are restored after the chunk, so the garbage rows sit above the valid
  length and are never attended. A freed slot's length is reset to 0, so
  its writes stay inside the pool.
- Per-slot sampling: each request carries its own temperature / top-k /
  top-p and a ``torch.Generator`` seeded from its ``seed``; each step draws
  one Gumbel vector per sampled slot from that slot's own generator, the
  same draws its one-shot ``generate`` makes, so a sampled request's tokens
  equal its one-shot rollout whatever shares the pool.
- Repetition penalty: a per-slot presence row in a [S, V] bool pool,
  applied and grown every step (a slot with penalty 1 is untouched).
- Prefix cache (``prefix_store``): admissions prefill through
  ``model.prefix_cached_prefill``; penalized requests bypass it.
- Chunked admission (``prefill_chunk`` > 0): an image or video request on
  an engine without a strategy is admitted as a ``model.ChunkedPrefill``,
  one step (a tower block group, the compaction or a ``prefill_chunk``-row
  decoder segment) per loop iteration with a decode chunk in between, so a
  live slot waits at most one step, not a whole prefill, between its
  chunks (``stats["max_decode_gap_ms"]``).
- ``lock``: the engine lock, shared with the server, held around every
  engine call.

- Speculative slots (``speculative`` = m > 0): every dispatch runs
  ``chunk`` rounds of on-device prompt lookup over each slot's window of
  its last SPEC_WINDOW tokens (``_lookup_props``), one verify chunk of
  m + 1 rows per slot (the decode kernel at t_c = m + 1), acceptance
  (greedy prefixes; the speculative-sampling rule for sampled slots;
  penalized slots at a = 0 with their penalized row-0 pick), the
  per-slot length roll-back and the window shift, all queued as device
  work from a host loop (``_spec_rounds``): the host reads the rounds'
  tokens once per dispatch. Admission keeps ``chunk`` x (m + 1) rows of
  headroom.
- ``kv_quant="int4"``: the pool holds int4 values packed two a byte with
  per-row scales (a quarter of the bf16 pool's value bytes); its decode
  attention is the plain int4 route (``attention.decode_int4_plain``), as
  the reference keeps int4 pools off its Pallas kernel, counted in
  ``stats["int4_plain_decode_calls"]``.

Auto windows are not ported (ValueError: the decode kernel already reads
only each slot's live prefix).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from visionselector_tpu_torch.kernels import attention as A
from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod
from visionselector_tpu_torch.models.qwen25vl import model as model_mod

# Tokens of a speculative slot's lookup window (the reference's default
# ctx_window): the prompt-lookup proposals come from its last 128 tokens.
SPEC_WINDOW = 128
AUTO_WINDOW_REFUSAL = (
    "auto_window is not ported: the decode kernel already reads only each "
    "slot's live prefix of the pool, which is what the reference's static "
    "attention windows bound (ROADMAP §1, \"Do not port\")")


@torch.no_grad()
def _decode_chunk_slots(params, cache, cur, pos, live, k: int,
                        temps=None, tps=None, tks=None, gens=None,
                        pres=None, rps=None, attn_impl=None):
    """Advance every slot ``k`` decode steps.

    cur/pos/live: [S] current token, rope position, live mask (device).
    Dead slots keep their token frozen and get their cache lengths back.
    ``temps`` given (the pool holds a sampled slot): temps/tps [S] f32 and
    tks [S] int64 on the device, and ``gens`` the per-slot generators
    (None for greedy or dead slots); a live sampled slot draws one Gumbel
    vector from its generator per step. ``pres`` [S, V] bool / ``rps`` [S]
    f32 given (a penalized slot is live): every step penalizes the logits
    and marks the emitted token. Returns (toks [k, S], cache).
    """
    len0 = cache.length.clone()
    tok, toks = cur, []
    for _ in range(k):
        tok, cache = model_mod._decode_rows(
            params, cache, tok, pos, live,
            gens if temps is not None else None, temps, tps, tks, pres,
            None if rps is None else rps[:, None], attn_impl)
        pos = torch.where(live, pos + 1, pos)
        toks.append(tok)
    cache.length = torch.where(live[None, :], cache.length, len0)
    return torch.stack(toks), cache


def _lookup_props(buf, n: int, m: int):
    """On-device prompt lookup over per-slot token windows.

    buf [S, C] int64: each slot's last C tokens, oldest first (-1 pads).
    Returns [S, m]: the m tokens that followed the most recent EARLIER
    occurrence of the window's final n-gram, zero where the window ends
    first or there is no match (the host ``_prompt_lookup`` within the
    window)."""
    s, c = buf.shape
    tail = buf[:, c - n:]  # [S, n]
    num_w = c - n  # candidate starts, the tail's own excluded
    windows = buf.unfold(1, n, 1)[:, :num_w]  # [S, num_w, n]
    match = (windows == tail[:, None, :]).all(-1)
    starts = torch.arange(num_w, device=buf.device)
    best = torch.where(match, starts, -1).amax(-1)  # [S]
    gidx = best[:, None] + n + torch.arange(m, device=buf.device)
    cont = buf.gather(1, gidx.clamp(0, c - 1))
    return torch.where((gidx < c) & (best >= 0)[:, None], cont, 0)


@torch.no_grad()
def _spec_rounds(params, cache, cur, pos, live, buf, m: int, rounds: int,
                 ngram: int, temps=None, tps=None, tks=None, gens=None,
                 pres=None, rps=None, attn_impl=None):
    """``rounds`` speculative rounds over every slot, queued as device work
    with no host read: per round the lookup (``_lookup_props``), one
    verify chunk of m + 1 rows per slot (``model._verify_logits``),
    acceptance, each live slot's length set to its old length + a + 1
    (dead slots keep theirs), the a + 1 emitted tokens appended to the
    window, and the slot's current token and rope position advanced.

    cur / pos / live [S]; buf [S, C] (``_lookup_props``). Greedy slots
    accept their exact greedy prefix. ``temps`` given (a live slot
    samples): temps / tps [S] f32, tks [S] int64 and ``gens`` the
    per-slot generators (None for greedy or dead slots); a live sampled
    slot draws ``model.spec_draws`` once per round and accepts by the
    speculative-sampling rule. ``pres`` [S, V] / ``rps`` [S] given (a
    penalized slot is live): a slot with rps != 1 emits only the penalized
    pick of row 0 (argmax, or ``sample_token`` with the round's Gumbel
    noise), a = 0, and marks it in ``pres``. Returns (emitted [rounds, S,
    m + 1], a [rounds, S] with -1 for dead slots, the cache)."""
    dev = cur.device
    s = cur.shape[0]
    rows = torch.arange(s, device=dev)
    c = buf.shape[1]
    vocab = params.lm.cfg.vocab_size
    sampled = temps is not None
    is_samp = temps > 0.0 if sampled else None
    pen = None if rps is None else rps != 1.0
    ems, accs = [], []
    for _ in range(rounds):
        len0 = cache.length
        # a window of padding (a dead slot, a context shorter than the
        # n-gram) can propose its -1 pads: propose 0 there, as the host
        # lookup pads (acceptance only keeps tokens the target emits)
        props = _lookup_props(buf, ngram, m).clamp(min=0)
        logits, cache = model_mod._verify_logits(params, cache, cur, props,
                                                 pos, attn_impl)
        emitted = logits.argmax(-1)  # [S, m + 1]
        a = model_mod._greedy_accept(emitted, props)
        noise = None
        if sampled:
            draws = [model_mod.spec_draws(g, m, vocab) if g is not None
                     else (logits.new_zeros(m), logits.new_zeros(vocab))
                     for g in gens]
            u = torch.stack([d[0] for d in draws])
            noise = torch.stack([d[1] for d in draws])
            probs = model_mod._nucleus_probs(logits, temps[:, None],
                                             tps[:, None], tks[:, None])
            em_s, a_s = model_mod._spec_accept(probs, props, u, noise)
            emitted = torch.where(is_samp[:, None], em_s, emitted)
            a = torch.where(is_samp, a_s, a)
        if pen is not None:
            l0 = model_mod.penalize_logits(logits[:, 0], pres, rps[:, None])
            e0 = l0.argmax(-1)
            if sampled:
                e0 = model_mod.sample_token(l0, noise, temps, tps, tks)
            emitted[:, 0] = torch.where(pen, e0, emitted[:, 0])
            a = torch.where(pen, 0, a)
            pres[rows, emitted[:, 0]] |= pen & live
        a = torch.where(live, a, -1)  # dead slots consume nothing
        cache.length = torch.where(live[None, :], len0 + a[None, :] + 1,
                                   len0)
        ext = torch.cat([buf, emitted], dim=1)  # [S, C + m + 1]
        buf = ext.gather(1, (a + 1)[:, None] + torch.arange(c, device=dev))
        cur = torch.where(live, emitted[rows, a.clamp(min=0)], cur)
        pos = pos + torch.where(live, a + 1, 0)
        ems.append(emitted)
        accs.append(a)
    return torch.stack(ems), torch.stack(accs), cache


def _insert_slot(pool, new_k, new_v, new_len, slot: int):
    """Copy one request's prefill KV ([L, 1, T, H, D]) into pool slot
    ``slot`` in place, quantized when the pool is int8 and quantized and
    packed when it is int4; rows past it are zeroed, as the reference pads
    them."""
    t = min(new_k.shape[2], pool.k.shape[2])
    if isinstance(pool, lm_mod.QuantKVCache):
        bits = 4 if pool.packed else 8
        k8, ks = lm_mod.quantize_kv(new_k[:, 0, :t], bits)
        v8, vs = lm_mod.quantize_kv(new_v[:, 0, :t], bits)
        if pool.packed:
            k8, v8 = lm_mod.pack_int4(k8), lm_mod.pack_int4(v8)
        pairs = ((pool.k, k8), (pool.v, v8), (pool.k_scale, ks),
                 (pool.v_scale, vs))
    else:
        pairs = ((pool.k, new_k[:, 0, :t]), (pool.v, new_v[:, 0, :t]))
    for buf, upd in pairs:
        buf[:, slot, :t] = upd
        buf[:, slot, t:] = 0
    pool.length[:, slot] = new_len[:, 0]
    return pool


@dataclasses.dataclass
class _Slot:
    tokens: list
    max_new: int
    eos: Tuple[int, ...]
    result: object  # GenerationResult skeleton from the prefill
    done_event: threading.Event
    t_submit: float
    item: dict = None
    chunks: int = 0
    # prompt ids + emitted tokens, the lookup window's source (speculative
    # slots only; None otherwise)
    ctx: list = None
    spec_proposed: int = 0
    spec_accepted: int = 0


class ContinuousBatcher:
    """Slot-based continuous-batching decode engine over one model engine.

    ``submit()`` blocks until the request's GenerationResult is ready; a
    single worker thread owns the engine: it prefills queued requests into
    free slots and advances all live slots one chunk per dispatch. Stats
    (``admitted``, ``mid_flight_joins``, ``max_concurrent``, ``chunks``,
    ``rejected_too_long``, ...) expose the continuous behaviour.

    ``kv_quant="int8"`` (or ``kv_int8=True``) keeps the pool in int8 with
    per-row scales: half the bytes of a bf16 pool; ``kv_quant="int4"``
    packs int4 values two a byte, a quarter, on the plain int4 decode
    route. ``decode_attn``: None (the decode kernel on the card) or
    "plain" (the dense plain path). ``speculative`` = m > 0 runs each
    dispatch as ``chunk`` speculative rounds of m proposals per slot from
    an ``ngram`` lookup over the slot's last SPEC_WINDOW tokens
    (``spec_steps``, ``spec_proposed``, ``spec_accepted``, ``spec_tokens``
    in the stats; a result's ``spec_proposed`` / ``spec_accepted`` are its
    own, penalized slots' rounds not counted).
    ``prefill_chunk`` > 0 admits image requests in steps
    (``ChunkedPrefill``; ``prefill_vit_segments`` > 1 also splits the
    tower): ``prefill_chunks`` counts the steps, ``chunked_admissions``
    the requests, and ``max_decode_gap_ms`` is the longest wall gap between
    two decode chunks while a slot was live.
    """

    def __init__(self, engine, n_slots: int = 8, t_max: int = 2048,
                 chunk: int = 8, lock: Optional[threading.Lock] = None,
                 prefix_store=None, speculative: int = 0, ngram: int = 3,
                 kv_int8: bool = False,
                 prefill_chunk: int = 0, prefill_vit_segments: int = 0,
                 decode_attn: str | None = None,
                 auto_window: bool = False,
                 kv_quant: Optional[str] = None,
                 replay=None, worker: bool = True):
        if auto_window:
            raise ValueError(AUTO_WINDOW_REFUSAL)
        if speculative < 0 or not 0 < ngram < SPEC_WINDOW:
            raise ValueError(f"speculative must be >= 0 and ngram in "
                             f"(0, {SPEC_WINDOW}), got {speculative}, "
                             f"{ngram}")
        if kv_quant not in (None, "", "int8", "int4"):
            raise ValueError(f"kv_quant must be int8 or int4, got "
                             f"{kv_quant!r}")
        if decode_attn not in (None, "plain"):
            raise ValueError(f"decode_attn must be None or 'plain', got "
                             f"{decode_attn!r}")
        self.engine = engine
        self.n_slots = n_slots
        self.t_max = t_max
        self.chunk = chunk
        self.speculative = speculative
        self.ngram = ngram
        self.kv_quant = kv_quant or ("int8" if kv_int8 else None)
        self.decode_attn = decode_attn
        self.device = engine.device
        self.prefix_store = prefix_store
        self.prefill_chunk = prefill_chunk
        self.prefill_vit_segments = prefill_vit_segments
        # held around every engine call; the server passes its own
        self.engine_lock = lock if lock is not None else threading.Lock()
        self._admitting = None  # (ChunkedPrefill, item, slot index)
        self.cv = threading.Condition()
        self.queue: collections.deque = collections.deque()
        self.slots: list[Optional[_Slot]] = [None] * n_slots
        self.cur = np.zeros(n_slots, np.int64)
        self.pos = np.zeros(n_slots, np.int64)
        self.live = np.zeros(n_slots, bool)
        # per-slot sampling state (temperature 0 = greedy slot)
        self.temps = np.zeros(n_slots, np.float32)
        self.tps = np.ones(n_slots, np.float32)
        self.tks = np.zeros(n_slots, np.int64)  # top-k, <= 0 = off
        self.gens: list[Optional[torch.Generator]] = [None] * n_slots
        # per-slot repetition penalty (1.0 = off) and the [S, V] presence
        # pool (lazy with the KV pool); a freed slot's stale row is
        # overwritten by a penalized occupant and ignored by others
        self.rps = np.ones(n_slots, np.float32)
        self.pres = None
        self.pool = None  # KVCache or QuantKVCache, lazy
        self.stats = dict(admitted=0, mid_flight_joins=0, max_concurrent=0,
                          chunks=0, rejected_too_long=0,
                          prefill_chunks=0, chunked_admissions=0,
                          max_decode_gap_ms=0.0,
                          spec_steps=0, spec_proposed=0, spec_accepted=0,
                          spec_tokens=0, int4_plain_decode_calls=0)
        self._last_decode_t = None
        # tensor parallelism: rank 0's end of serve_tp.TPLink (every
        # engine operation below is announced to the follower ranks), or
        # None; a follower rank's batcher runs no worker thread: it
        # replays rank 0's operations (``serve_tp.follow``)
        self.replay = replay
        self._running = worker
        self._thread = threading.Thread(target=self._run, daemon=True)
        if worker:
            self._thread.start()

    # -- public API ------------------------------------------------------

    def submit(self, request: dict, max_new_tokens: int = 64,
               eos_token_ids: Optional[Tuple[int, ...]] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: int = 0, top_k: int = 0,
               repetition_penalty: float = 1.0):
        """request: generate() kwargs (input_ids, pixel_values, grid_thw,
        pixel_values_videos, video_grid_thw, second_per_grid_ts);
        sampling knobs may ride in the dict or as explicit kwargs. Blocks
        until decode finishes; returns the GenerationResult."""
        request = dict(request)
        temperature = float(request.pop("temperature", temperature))
        top_p = float(request.pop("top_p", top_p))
        seed = int(request.pop("seed", seed))
        top_k = int(request.pop("top_k", top_k))
        repetition_penalty = float(
            request.pop("repetition_penalty", repetition_penalty))
        item = dict(request=request, max_new=max_new_tokens,
                    eos=eos_token_ids, done=threading.Event(),
                    temperature=temperature, top_p=top_p, seed=seed,
                    top_k=top_k, repetition_penalty=repetition_penalty,
                    result=None, error=None, t_submit=time.perf_counter())
        with self.cv:
            if not self._running:
                raise RuntimeError("batcher shut down")
            self.queue.append(item)
            self.cv.notify_all()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def shutdown(self):
        with self.cv:
            self._running = False
            self.cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=30)

    # -- worker ----------------------------------------------------------

    def _free_slots(self):
        busy = self._admitting[2] if self._admitting is not None else -1
        return [i for i, s in enumerate(self.slots)
                if s is None and i != busy]

    def _mark_decode(self):
        """Track the max wall gap between consecutive decode dispatches
        over a continuously live pool (the streaming stall metric)."""
        now = time.perf_counter()
        if self._last_decode_t is not None:
            self.stats["max_decode_gap_ms"] = max(
                self.stats["max_decode_gap_ms"],
                (now - self._last_decode_t) * 1e3)
        self._last_decode_t = now

    def _init_pool(self, proto_cache):
        cfg = self.engine.cfg.text
        self.pres = torch.zeros((self.n_slots, cfg.vocab_size),
                                dtype=torch.bool, device=self.device)
        self.pool = lm_mod.init_kv_cache(
            cfg, self.n_slots, self.t_max, self.device, proto_cache.k.dtype,
            quant=self.kv_quant or False)

    def _op_admit(self, item, slot_idx):
        """One-shot admission prefill, then slot install. Through the
        prefix store when there is one, except for penalized requests: its
        reuse path does not give the prefill's last-row logits that the
        penalized first token is picked from (``generate_prefix_cached``
        bypasses the store the same way)."""
        if (self.prefix_store is not None
                and item.get("repetition_penalty", 1.0) == 1.0):
            state = model_mod.prefix_cached_prefill(
                self.engine, self.prefix_store, **item["request"],
                max_new_tokens=item["max_new"], eos_token_ids=item["eos"])
        else:
            state = self.engine.generate(
                **item["request"], max_new_tokens=item["max_new"],
                eos_token_ids=item["eos"], _defer_decode=True)
        self._install(state, item, slot_idx)

    def _chunk_eligible(self, item) -> bool:
        """Chunked admission takes image and video requests on an engine
        that has ``start_chunked_prefill`` (an ``OVEngine`` admits one-shot,
        as the reference's batcher admits an engine without it) and no
        strategy (strategy captures are one program and text-only prefills
        are short), and only without a prefix store (its reuse path wins
        over segmenting)."""
        req = item["request"]
        return (self.prefill_chunk > 0 and self.prefix_store is None
                and getattr(self.engine, "strategy", None) is None
                and hasattr(self.engine, "start_chunked_prefill")
                and (req.get("pixel_values") is not None
                     or req.get("pixel_values_videos") is not None))

    def _install(self, state, item, slot_idx):
        """Move a finished admission prefill into slot ``slot_idx``."""
        eng = self.engine
        eos = tuple(state.eos_token_ids)
        rp = float(item.get("repetition_penalty", 1.0))
        pres_row = None
        if rp != 1.0:
            # HF semantics: the prefill's last-row logits are penalized
            # too, so the first token is re-picked before any use
            ids = np.asarray(item["request"]["input_ids"]).reshape(-1)
            pres_row, state.next_token = model_mod.rep_penalty_setup(
                eng.cfg.text.vocab_size, ids, state.logits,
                state.next_token, rp, item["temperature"], item["top_p"],
                item.get("top_k", 0), item["seed"])
        state.result.first_token_seconds = (
            time.perf_counter() - item["t_submit"])
        if state.next_token in eos or item["max_new"] <= 1:
            state.result.tokens = (
                [] if state.next_token in eos or item["max_new"] < 1
                else [state.next_token])
            state.result.total_seconds = (
                time.perf_counter() - item["t_submit"])
            item["result"] = state.result
            item["done"].set()
            return
        t_valid = int(state.cache.length.max())
        # a speculative dispatch may run a finishing slot up to chunk
        # rounds of m + 1 rows past its budget
        headroom = max(self.chunk, self.chunk * (self.speculative + 1)
                       if self.speculative > 0 else 0)
        if t_valid + item["max_new"] + headroom > self.t_max:
            # request too long for the slot pool: serve it one-shot
            self.stats["rejected_too_long"] += 1
            item["result"] = eng.generate(
                **item["request"], max_new_tokens=item["max_new"],
                eos_token_ids=item["eos"],
                temperature=item["temperature"], top_p=item["top_p"],
                seed=item["seed"], top_k=item.get("top_k", 0),
                repetition_penalty=rp)
            item["done"].set()
            return
        if self.pool is None:
            self._init_pool(state.cache)
        self.pool = _insert_slot(self.pool, state.cache.k, state.cache.v,
                                 state.cache.length, slot_idx)
        self.cur[slot_idx] = state.next_token
        self.pos[slot_idx] = state.start_pos
        self.live[slot_idx] = True
        self.temps[slot_idx] = item["temperature"]
        self.tps[slot_idx] = item["top_p"]
        self.tks[slot_idx] = item.get("top_k", 0)
        self.rps[slot_idx] = rp
        if pres_row is not None:
            self.pres[slot_idx] = pres_row
        self.gens[slot_idx] = (
            model_mod.sampling_generator(item["seed"], self.device)
            if item["temperature"] > 0.0 else None)
        ctx = None
        if self.speculative > 0:
            ids = np.asarray(item["request"]["input_ids"]).reshape(-1)
            ctx = list(map(int, ids)) + [state.next_token]
        self.slots[slot_idx] = _Slot(
            tokens=[state.next_token], max_new=item["max_new"], eos=eos,
            result=state.result, done_event=item["done"],
            t_submit=item["t_submit"], item=item, ctx=ctx)
        self.stats["admitted"] += 1
        if sum(s is not None for i, s in enumerate(self.slots)
               if i != slot_idx):
            self.stats["mid_flight_joins"] += 1
        self.stats["max_concurrent"] = max(
            self.stats["max_concurrent"],
            sum(s is not None for s in self.slots))

    def _fail_all(self, exc: Exception):
        """Deliver ``exc`` to every live slot and queued item, then mark
        the batcher dead (a poisoned pool must not serve further)."""
        with self.cv:
            self._running = False
            if self._admitting is not None:
                _, item, _ = self._admitting
                item["error"] = exc
                item["done"].set()
                self._admitting = None
            for i, slot in enumerate(self.slots):
                if slot is not None:
                    slot.item["error"] = exc
                    slot.done_event.set()
                    self.slots[i] = None
                    self.live[i] = False
            while self.queue:
                item = self.queue.popleft()
                item["error"] = exc
                item["done"].set()

    def _finalize(self, idx, slot):
        slot.result.tokens = slot.tokens[: slot.max_new]
        slot.result.total_seconds = time.perf_counter() - slot.t_submit
        slot.result.decode_dispatches = slot.chunks
        if self.speculative > 0:
            slot.result.spec_proposed = slot.spec_proposed
            slot.result.spec_accepted = slot.spec_accepted
        slot.item["result"] = slot.result
        slot.done_event.set()
        self.slots[idx] = None
        self.live[idx] = False
        self.gens[idx] = None
        self.pool.length[:, idx] = 0  # a dead slot writes at rows [0, chunk)

    def _slot_state(self) -> dict:
        """The live slots' sampling and penalty state for a dispatch (the
        keywords of ``_decode_chunk_slots`` / ``_spec_rounds``)."""
        dev = self.device
        live = self.live
        samp = {}
        if np.any(self.temps[live] > 0.0):
            samp = dict(
                temps=torch.as_tensor(self.temps, device=dev),
                tps=torch.as_tensor(self.tps, device=dev),
                tks=torch.as_tensor(self.tks, device=dev),
                gens=[g if ok else None for g, ok in zip(self.gens, live)])
        if np.any(self.rps[live] != 1.0):
            samp.update(pres=self.pres,
                        rps=torch.as_tensor(self.rps, device=dev))
        return samp

    def _dispatch(self):
        """One decode chunk over the pool; returns the tokens [k, S]."""
        dev = self.device
        toks, self.pool = _decode_chunk_slots(
            self.engine.params, self.pool,
            torch.as_tensor(self.cur, device=dev),
            torch.as_tensor(self.pos, device=dev),
            torch.as_tensor(self.live, device=dev), self.chunk,
            attn_impl=self.decode_attn, **self._slot_state())
        return toks.cpu().numpy()  # waits for the chunk

    def _spec_dispatch(self):
        """``chunk`` speculative rounds over the pool (``_spec_rounds``);
        the lookup windows go up with the dispatch. Returns (emitted
        [rounds, S, m + 1], a [rounds, S]) as numpy: the one host read."""
        dev, c = self.device, SPEC_WINDOW
        buf = np.full((self.n_slots, c), -1, np.int64)
        for i, slot in enumerate(self.slots):
            if slot is not None:
                tail = slot.ctx[-c:]
                buf[i, c - len(tail):] = tail
        emitted, acc, self.pool = _spec_rounds(
            self.engine.params, self.pool,
            torch.as_tensor(self.cur, device=dev),
            torch.as_tensor(self.pos, device=dev),
            torch.as_tensor(self.live, device=dev),
            torch.as_tensor(buf, device=dev), self.speculative, self.chunk,
            self.ngram, attn_impl=self.decode_attn, **self._slot_state())
        host = torch.cat([emitted.flatten(), acc.flatten()]).cpu().numpy()
        n = emitted.numel()
        return (host[:n].reshape(emitted.shape),
                host[n:].reshape(acc.shape))

    def _harvest(self, toks):
        """Hand out a plain chunk's tokens [k, S]: each slot takes them up
        to its EOS or budget."""
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot.chunks += 1
            finished = False
            for t in toks[:, i].tolist():
                if t in slot.eos:
                    finished = True
                    break
                slot.tokens.append(t)
                if len(slot.tokens) >= slot.max_new:
                    finished = True
                    break
            if finished:
                self._finalize(i, slot)
            else:
                self.cur[i] = slot.tokens[-1]
                self.pos[i] += self.chunk

    def _spec_harvest(self, emitted, acc):
        """Hand out the speculative rounds' tokens: per round a live slot
        takes its a + 1 emitted tokens, up to its EOS or budget."""
        m = self.speculative
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot.chunks += 1
            consumed, finished = 0, False
            counted = self.rps[i] == 1.0  # penalized slots reject by design
            for r in range(acc.shape[0]):
                a_i = int(acc[r, i])
                if counted:
                    self.stats["spec_proposed"] += m
                    self.stats["spec_accepted"] += a_i
                    slot.spec_proposed += m
                    slot.spec_accepted += a_i
                for t in emitted[r, i, :a_i + 1].tolist():
                    if t in slot.eos:
                        finished = True
                        break
                    slot.tokens.append(t)
                    slot.ctx.append(t)
                    consumed += 1
                    if len(slot.tokens) >= slot.max_new:
                        finished = True
                        break
                if finished:
                    break
            self.stats["spec_tokens"] += consumed
            if finished:
                self._finalize(i, slot)
            else:
                self.cur[i] = slot.tokens[-1]
                self.pos[i] += consumed

    def _run(self):
        with torch.no_grad():
            self._loop()

    def _loop(self):
        while True:
            with self.cv:
                while (self._running and not self.queue
                       and not any(self.live) and self._admitting is None):
                    self.cv.wait()
                if not self._running:
                    if self._admitting is not None:
                        _, item, _ = self._admitting
                        item["error"] = RuntimeError("batcher shut down")
                        item["done"].set()
                        self._admitting = None
                    for item in self.queue:
                        item["error"] = RuntimeError("batcher shut down")
                        item["done"].set()
                    return
                pending, start_chunked = [], None
                free = self._free_slots()
                while self.queue and free and self._admitting is None:
                    item, idx = self.queue.popleft(), free.pop(0)
                    if self._chunk_eligible(item):
                        # one segmented admission at a time; it starts
                        # below, outside the condition
                        start_chunked = (item, idx)
                        break
                    pending.append((item, idx))
            for item, idx in pending:
                try:
                    with self.engine_lock:
                        self._op("admit", item, idx)
                except Exception as e:  # noqa: BLE001 — report to waiter
                    item["error"] = e
                    item["done"].set()
            if start_chunked is not None:
                item, idx = start_chunked
                try:
                    with self.engine_lock:
                        self._op("start_chunked", item, idx)
                except Exception as e:  # noqa: BLE001 — report to waiter
                    item["error"] = e
                    item["done"].set()
            if self._admitting is not None:
                # one step of the segmented admission per iteration; live
                # slots get their decode chunk in between
                item = self._admitting[1]
                try:
                    with self.engine_lock:
                        self._op("admission_step")
                except Exception as e:  # noqa: BLE001 — report to waiter
                    item["error"] = e
                    item["done"].set()
            if not any(self.live):
                self._last_decode_t = None
                continue
            try:
                with self.engine_lock:
                    self._op("dispatch")
            except Exception as e:  # noqa: BLE001 — fail fast, not hang
                # a failed dispatch poisons the shared pool: wake every
                # waiter with the error rather than leave them hanging
                self._fail_all(e)
                return

    # -- engine operations (with the engine lock held) -----------------

    def _op(self, name: str, *args):
        """Run engine operation ``name``, announced first to the follower
        ranks under tensor parallelism (requests go as their host fields:
        ``wire_item``)."""
        if self.replay is not None:
            self.replay.announce(
                "batcher", name,
                tuple(wire_item(a) if isinstance(a, dict) else a
                      for a in args), False)
        return getattr(self, "_op_" + name)(*args)

    def _op_start_chunked(self, item, idx):
        """Start a segmented admission (one-shot if the engine declines)."""
        job = self.engine.start_chunked_prefill(
            **item["request"], max_new_tokens=item["max_new"],
            eos_token_ids=item["eos"], prefill_chunk=self.prefill_chunk,
            vit_segments=self.prefill_vit_segments)
        if job is None:  # not eligible after all
            self._op_admit(item, idx)
        else:
            self._admitting = (job, item, idx)

    def _op_admission_step(self):
        """One step of the segmented admission; its slot install after
        the last."""
        job, item, idx = self._admitting
        try:
            done = job.step()
            self.stats["prefill_chunks"] += 1
            if done:
                self._admitting = None
                self._install(job.finish(), item, idx)
                self.stats["chunked_admissions"] += 1
        except BaseException:
            self._admitting = None
            raise

    def _op_dispatch(self):
        """One decode dispatch over the pool and its tokens handed out."""
        int4_0 = A.INT4_DECODE_CALLS
        if self.speculative > 0:
            out = self._spec_dispatch()
        else:
            toks = self._dispatch()
        self.stats["int4_plain_decode_calls"] += (
            A.INT4_DECODE_CALLS - int4_0)
        self.stats["chunks"] += 1
        self._mark_decode()
        if self.speculative > 0:
            self.stats["spec_steps"] += self.chunk
            self._spec_harvest(*out)
        else:
            self._harvest(toks)


def wire_item(item: dict) -> dict:
    """A queued request's host fields (no event, result or error): what a
    tensor-parallel follower is sent (``unwire_item`` rebuilds it)."""
    return {k: v for k, v in item.items()
            if k not in ("done", "result", "error")}


def unwire_item(fields: dict) -> dict:
    return dict(fields, done=threading.Event(), result=None, error=None)
