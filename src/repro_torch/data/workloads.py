"""Workload generation (paper §7.1); port of ``repro.data.workloads``
(numpy only, verbatim).

* ``sharegpt``  — ShareGPT-like: naturally varying prompt/completion lengths
  (log-normal mixture fitted to the published ShareGPT length statistics;
  the dataset itself is not redistributable offline).
* ``random``    — the paper's synthetic decode-heavy workload: fixed
  10-token prompts, 128 generated tokens.
* ``long_prompt_burst`` — the chunked-prefill stress case: bimodal prompt
  lengths (mostly short chat turns, a long-document minority) arriving in
  Poisson *bursts*, so several long prompts can land on the same tick and
  stall co-resident decodes unless prefill is budgeted.
* ``skewed_expert_load`` — the expert-rebalancer stress case: prompt tokens
  are drawn from a Zipf distribution over the vocabulary, so a few dominant
  tokens (and therefore the experts they route to) carry most of the
  dispatch load — static expert placement concentrates that load on a few
  EWs, which is exactly what load-aware rebalancing exists to fix.
* ``mixed_slo`` — the SLO-class stress case for the multi-class admission
  plane: a Poisson stream of short *interactive* requests (tight
  first-token deadlines) over periodic bulk waves of long *batch* requests
  that saturate every slot — without preempt-and-requeue, interactive TTFT
  degenerates to the batch residency time.
* ``multi_turn_chat`` — the prefix-cache stress case: sessions of
  ``chat_turns`` requests where every turn's prompt replays the whole
  conversation so far (turn t = turn chunks 0..t, deterministic per
  session), so successive turns share a growing exact token prefix —
  without prefix reuse, the hottest KV in the system is recomputed every
  turn.
* Arrivals follow a Poisson process of configurable rate.

Also provides a token-stream iterator for the training example (synthetic
LM data, deterministic given seed).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np


@dataclass(frozen=True)
class Request:
    request_id: str
    arrival: float            # seconds since epoch 0
    prompt_len: int
    max_new_tokens: int
    seed: int
    token_dist: str = "uniform"   # "uniform" | "zipf" | "chat"
    zipf_a: float = 1.3           # Zipf exponent (smaller = heavier skew)
    slo_class: str = "standard"   # interactive | standard | batch
    deadline: float = -1.0        # absolute first-token deadline on the
    #                               virtual clock (-1 = none)
    session: str = ""             # affinity key (multi-turn conversations)
    turn: int = 0                 # conversation turn index ("chat" dist)

    def prompt_tokens(self, vocab: int) -> np.ndarray:
        if self.token_dist == "chat":
            # conversation replay: turn t's prompt is the concatenation of
            # turn chunks 0..t — successive turns of a session share the
            # exact token prefix (what the prefix-cache plane exploits);
            # seed is the *session* seed, shared by all its turns
            return chat_history_tokens(self.seed, self.turn, vocab)
        rng = np.random.default_rng(self.seed)
        if self.token_dist == "zipf":
            # heavy-tailed token ids: a handful of dominant tokens -> a
            # handful of dominant experts (token->expert affinity is fixed
            # by the router weights)
            toks = rng.zipf(self.zipf_a, size=(self.prompt_len,)) - 1
            return (toks % vocab).astype(np.int32)
        return rng.integers(0, vocab, size=(self.prompt_len,),
                            dtype=np.int32)


def _chat_turn_rng(session_seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng(session_seed + 7919 * k)


def chat_turn_len(session_seed: int, k: int) -> int:
    """Length of one turn chunk — MUST mirror the first draw inside
    ``chat_history_tokens`` so ``Request.prompt_len`` metadata matches
    the actual prompt."""
    return int(_chat_turn_rng(session_seed, k).integers(4, 10))


def chat_history_tokens(session_seed: int, turn: int,
                        vocab: int) -> np.ndarray:
    """Deterministic conversation history: per-(session, turn) token
    chunks, concatenated. ``chat_history_tokens(s, t)`` is a strict prefix
    of ``chat_history_tokens(s, t+1)``."""
    parts = []
    for k in range(turn + 1):
        rng = _chat_turn_rng(session_seed, k)
        n = int(rng.integers(4, 10))
        parts.append(rng.integers(0, vocab, size=(n,), dtype=np.int32))
    return np.concatenate(parts)


def poisson_arrivals(rate_rps: float, duration: float,
                     rng: np.random.Generator) -> np.ndarray:
    n = rng.poisson(rate_rps * duration)
    return np.sort(rng.uniform(0.0, duration, size=n))


def burst_arrivals(rate_rps: float, duration: float,
                   rng: np.random.Generator, burst_size: int = 3,
                   burst_spread: float = 0.02) -> np.ndarray:
    """Poisson process over burst *centers* (rate preserved overall): each
    center spawns ``burst_size`` arrivals jittered by ``burst_spread``."""
    centers = poisson_arrivals(rate_rps / burst_size, duration, rng)
    ts = (centers[:, None] +
          rng.uniform(0.0, burst_spread, size=(len(centers), burst_size)))
    return np.sort(np.clip(ts.reshape(-1), 0.0, duration))


def make_workload(kind: str, rate_rps: float, duration: float,
                  seed: int = 0, max_prompt: int = 1024,
                  max_new: int = 256, long_frac: float = 0.3,
                  zipf_a: float = 1.3,
                  interactive_deadline: float = 0.5,
                  batch_wave: int = 8, batch_every: float = 2.0,
                  chat_turns: int = 4, chat_turn_gap: float = 0.6,
                  chat_max_new: int = 4) -> \
        List[Request]:
    rng = np.random.default_rng(seed)
    if kind == "multi_turn_chat":
        # the prefix-cache stress case: sessions replay their whole
        # conversation every turn (turn t's prompt = turns 0..t of the
        # history), so all but the newest turn chunk is KV the serving
        # stack already computed. Session starts are Poisson; turns are
        # spaced ``chat_turn_gap`` apart (think time), enough for the
        # previous turn to finish and its slot to be adopted by the cache.
        reqs = []
        starts = poisson_arrivals(max(rate_rps, 1e-6) / chat_turns,
                                  duration, rng)
        for s, t0 in enumerate(starts):
            sseed = seed * 100003 + 6151 * (s + 1)
            for t in range(chat_turns):
                plen = sum(chat_turn_len(sseed, k) for k in range(t + 1))
                reqs.append(Request(
                    f"chat-s{s}-t{t}", float(t0 + t * chat_turn_gap),
                    plen, chat_max_new, sseed, token_dist="chat",
                    session=f"chat-s{s}", turn=t))
        return sorted(reqs, key=lambda r: (r.arrival, r.request_id))
    if kind == "mixed_slo":
        # interactive Poisson stream: short prompts, short outputs, a
        # first-token deadline ``interactive_deadline`` after arrival
        reqs = []
        for i, t in enumerate(poisson_arrivals(rate_rps, duration, rng)):
            reqs.append(Request(
                f"mixed_slo-i{i}", float(t),
                int(rng.integers(4, 10)),
                int(np.clip(rng.integers(4, 10), 1, max_new)),
                seed * 100003 + i, slo_class="interactive",
                deadline=float(t) + interactive_deadline))
        # batch bulk arrivals: every ``batch_every`` seconds a wave of
        # ``batch_wave`` long-running requests lands at once (enough to
        # saturate a typical slot pool between waves)
        w = 0
        t_wave = 0.0
        while t_wave < duration:
            for j in range(batch_wave):
                reqs.append(Request(
                    f"mixed_slo-b{w}-{j}", float(t_wave),
                    int(rng.integers(6, 14)), max_new,
                    seed * 100003 + 50021 * (w + 1) + j,
                    slo_class="batch"))
            w += 1
            t_wave += batch_every
        return sorted(reqs, key=lambda r: (r.arrival, r.request_id))
    if kind == "long_prompt_burst":
        arrivals = burst_arrivals(rate_rps, duration, rng)
    else:
        arrivals = poisson_arrivals(rate_rps, duration, rng)
    reqs = []
    for i, t in enumerate(arrivals):
        token_dist = "uniform"
        if kind == "random":
            p_len, n_new = 10, 128
        elif kind == "skewed_expert_load":
            # decode-heavy like "random", but Zipf-distributed token ids so
            # per-expert dispatch load is heavily imbalanced
            p_len = int(np.clip(rng.integers(8, 17), 4, max_prompt))
            n_new = min(64, max_new)
            token_dist = "zipf"
        elif kind == "sharegpt":
            # log-normal prompt (~median 160 tok) and completion (~median 90)
            p_len = int(np.clip(rng.lognormal(5.0, 1.0), 4, max_prompt))
            n_new = int(np.clip(rng.lognormal(4.5, 0.8), 4, max_new))
        elif kind == "long_prompt_burst":
            # bimodal: short chat turns vs long documents near max_prompt
            if rng.uniform() < long_frac:
                p_len = int(rng.integers(max(5, max_prompt // 2),
                                         max_prompt + 1))
            else:
                p_len = int(rng.integers(4, max(5, max_prompt // 8)))
            n_new = int(np.clip(rng.lognormal(3.0, 0.6), 4, max_new))
        else:
            raise ValueError(kind)
        reqs.append(Request(f"{kind}-{i}", float(t), p_len, n_new,
                            seed * 100003 + i, token_dist=token_dist,
                            zipf_a=zipf_a))
    return reqs


def lm_batches(vocab: int, batch: int, seq: int, steps: int,
               seed: int = 0, learnable: bool = True) -> Iterator[dict]:
    """Synthetic LM training stream: returns {tokens, labels} per step.

    ``learnable=True`` generates affine-progression sequences
    (x[t+1] = (a*x[t] + b) mod V with fixed a,b) — a next-token function the
    model can actually learn, so training loss decreases below the uniform
    entropy floor. ``learnable=False`` gives uniform noise (floor = ln V).
    """
    rng = np.random.default_rng(seed)
    a = int(rng.integers(2, 7)) * 2 + 1  # odd -> bijective mod 2^k vocabs
    b = int(rng.integers(1, vocab))
    for _ in range(steps):
        if learnable:
            x0 = rng.integers(0, vocab, size=(batch, 1))
            toks = np.empty((batch, seq + 1), np.int64)
            toks[:, :1] = x0
            for t in range(seq):
                toks[:, t + 1] = (a * toks[:, t] + b) % vocab
            toks = toks.astype(np.int32)
        else:
            toks = rng.integers(0, vocab, size=(batch, seq + 1),
                                dtype=np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
