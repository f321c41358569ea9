"""Whether what the timed path served is correct: the plain float32
reference, run once the window has closed and the program is freed, over
a seeded sample of the finished requests.

For each sampled request the reference works out again, from the raw
image and ids the benchmark made and the weights made again from the
seed: the processor's pixel rows, the vision tower, the LIS scores, and
the decoder over the compacted prompt followed by the served tokens. It
reads three of the program's outputs to judge them:

- ``layout``: how many requests report another count of vision tokens,
  of kept tokens, or of prompt rows after compaction than the reference
  works out, or another number of answer tokens than asked for (exact:
  limit 0);
- ``select_gap``: the kept vision tokens (``selected_indices``) judged by
  the reference's scores: the largest amount by which a kept token's
  score lies below the reference's k-th best, in standard deviations of
  that request's scores. Near-ties swap under bf16 rounding, so this is
  small but not 0 on sound runs;
- ``logit_gap``: with the vision tokens the program kept (judged above),
  the widest gap by which a served token's logit lies below the
  reference's best at its position.

The control (``control=True``) puts the reference in fp8 (e4m3, a scale
per weight row and per activation row) in the program's place: its own
scores choose the kept tokens, and at each position of the same served
sequence the token its logits put first is judged as a served token.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import models, traffic
from benchmark.reference import common, decoder
from benchmark.reference import llava_ov15 as ov_ref
from benchmark.reference import qwen25vl as qwen_ref


def sample(served: list, check: dict, seed: int) -> list:
    """A seeded sample of finished requests: the one with the most served
    tokens, the one with the largest image, then others drawn from the
    seed until ``check.tokens`` served tokens or ``check.max_requests``."""
    done = [s for s in served if s.result is not None]
    if not done:
        return []
    rng = np.random.default_rng([seed, 7])
    order = list(rng.permutation(len(done)))
    first = [max(range(len(done)), key=lambda i: len(done[i].result.tokens)),
             max(range(len(done)), key=lambda i: done[i].work.patches)]
    picked, tokens = [], 0
    for i in first + order:
        if i in picked:
            continue
        if len(picked) >= check["max_requests"] or tokens >= check["tokens"]:
            break
        picked.append(i)
        tokens += len(done[i].result.tokens)
    return [done[i] for i in picked]


class Reference:
    """The plain model of one configuration over seeded weights."""

    def __init__(self, cfg: dict, seed: int, device, fp8: bool = False):
        common.fp32_matmul()
        self.cfg = cfg
        self.W = models.make_weights(cfg, seed, device)
        self.device = device
        self.lin = common.Linear(fp8)
        fam = cfg["family"]
        self.pre = models.PREFIXES[fam]
        self.tower = qwen_ref.vision if fam == "qwen25vl" else ov_ref.vision
        self.head = (self.pre["lm"] + "embed_tokens.weight"
                     if cfg["text_config"]["tie_word_embeddings"]
                     else "lm_head.weight")

    def prompt(self, s, mix: dict):
        """(grid, merged tokens [n, D], scores [n], ids,
        position ids [3, T], the decode start's offset from the compacted
        length) of served request ``s``, from its raw inputs."""
        cfg, v = self.cfg, self.cfg["vision_config"]
        proc = cfg["processor"]
        rows, grid = common.patchify(
            s.req.image, v["patch_size"], v["temporal_patch_size"],
            v["spatial_merge_size"], proc["min_pixels"], proc["max_pixels"])
        px = torch.as_tensor(rows, device=self.device)
        with torch.no_grad():
            merged = self.tower(self.W, v, px, grid, self.lin)
            scores = decoder.lis_scores(self.W, self.pre["scorer"], merged,
                                        self.lin)
        n = merged.shape[0]
        ids = traffic.prompt_ids(mix, cfg, n, s.req.question)
        tok = cfg["tokens"]["image_token_id"]
        if cfg["text_config"]["mrope"]:
            pos3, delta = common.mrope_ids(ids, grid,
                                           v["spatial_merge_size"], tok)
        else:
            pos3, delta = np.tile(np.arange(len(ids)), (3, 1)), 0
        return grid, merged, scores, ids, pos3, delta

    def logits(self, ids, merged, kept, pos3, delta, served):
        with torch.no_grad():
            return decoder.served_logits(
                self.W, self.pre["lm"], self.head, self.cfg["text_config"],
                ids, merged, kept, pos3, delta, served, self.lin,
                self.cfg["tokens"]["image_token_id"])


def select_gap(scores: torch.Tensor, kept: np.ndarray, k: int) -> float:
    s = scores.double()
    kth = torch.sort(s, descending=True).values[k - 1]
    low = s[torch.as_tensor(np.asarray(kept, np.int64),
                            device=s.device)].min()
    return float(max(0.0, (kth - low) / s.std()))


def gaps(ref_logits: torch.Tensor, tokens) -> np.ndarray:
    """Per position, how far token ``tokens[j]``'s logit lies below the
    best of ``ref_logits[j]``."""
    t = torch.as_tensor(np.asarray(tokens, np.int64),
                        device=ref_logits.device)
    best = ref_logits.max(-1).values
    return (best - ref_logits.gather(1, t[:, None])[:, 0]).cpu().numpy()


def judge(cfg: dict, mix: dict, served: list, seed: int, device,
          control: bool = False) -> dict:
    """The numbers compared for the sampled requests: {"layout",
    "select_gap", "logit_gap", "requests", "tokens"}."""
    picked = sample(served, mix["check"], seed)
    ref = Reference(cfg, seed, device)
    low = Reference(cfg, seed, device, fp8=True) if control else None
    out = dict(layout=0, select_gap=0.0, logit_gap=0.0,
               requests=len(picked), tokens=0)
    budget = cfg["selector"]["budget"]
    for s in picked:
        res = s.result
        grid, merged, scores, ids, pos3, delta = ref.prompt(s, mix)
        n = merged.shape[0]
        k = max(1, int(n * budget))
        served_toks = list(res.tokens)
        text = len(ids) - n
        if control:
            _, m_low, s_low, _, _, _ = low.prompt(s, mix)
            kept = decoder.top_k(s_low, k)
        else:
            kept = np.asarray(res.selected_indices, np.int64)
            out["layout"] += int(res.num_vision_tokens != n
                                 or res.prefill_len != text + k
                                 or len(kept) != k
                                 or len(served_toks) != s.req.max_new)
            if len(kept) != k or len(served_toks) == 0:
                continue
        out["select_gap"] = max(out["select_gap"],
                                select_gap(scores, kept, k))
        want = ref.logits(ids, merged, kept, pos3, delta, served_toks)
        if control:
            got = low.logits(ids, m_low, kept, pos3, delta, served_toks)
            chosen = got.argmax(-1).cpu().numpy()
            del got
        else:
            chosen = served_toks
        out["logit_gap"] = max(out["logit_gap"],
                               float(gaps(want, chosen).max()))
        out["tokens"] += len(served_toks)
        del want
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, number, limit)]) for the numbers that have a
    limit; every request sampled must have been judged."""
    rows = [(k, numbers[k], limits[k]) for k in ("layout", "select_gap",
                                                 "logit_gap")]
    ok = numbers["requests"] > 0 and all(v <= lim for _, v, lim in rows)
    return ok, rows
