"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes the requests of a run from ``--seed``.

Lengths follow the ShareGPT-like log-normal and uniform laws of the
port's ``data/workloads.py`` (frozen here), as mixtures with weights. So
that seeds change the order of the work and not its amount, every seed
gets the same multiset of lengths and arrival gaps: each law is read at
the stratified quantiles (i + 1/2) / n, and the seed shuffles them. The
seed alone draws the token ids and the pairing of lengths.

A closed loop (``{"kind": "closed", "clients": c}``) gives each client a
queue of requests, sent one after the other. With ``steady_start`` each
client's first request is caught part-way through its generation: its
context so far (prompt and output already written) is one prompt of a
length drawn from ``context``, which the set-up prefills, and what is
left of its output is drawn from ``residual``; both are read at the
stratified quantiles like every other length. An
open loop (``{"kind": "open", "rate_rps": r}``) sends requests at Poisson
times (``"arrivals": "burst"``: bursts of ``burst_size`` within
``burst_spread`` seconds, at the same mean rate).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
_NORMAL = NormalDist()


def load_mix(name: str) -> dict:
    path = HERE / "traffic" / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no traffic mix {name!r} (looked for {path})")
    return json.loads(path.read_text())


@dataclass
class Request:
    rid: str
    prompt: np.ndarray            # int32 token ids
    max_new: int
    client: int = -1              # closed loop: the client that sends it
    due: float = 0.0              # open loop: seconds after the window opens


def _seed_words(seed: int, salt: int) -> List[int]:
    """``seed`` (any whole number, also past 2**63) as 32-bit words for
    numpy's SeedSequence, with a salt per stream."""
    seed = int(seed)
    words = [salt, 1 if seed < 0 else 0]
    seed = abs(seed)
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def rng_for(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(_seed_words(seed,
                                                                    salt)))


def quantile(law: dict, u: float) -> int:
    """The law's value at quantile ``u`` in (0, 1), as a whole number."""
    if law["dist"] == "uniform":
        lo, hi = int(law["min"]), int(law["max"])
        return min(hi, lo + int(u * (hi - lo + 1)))
    if law["dist"] == "lognormal":
        v = math.exp(law["mu"] + law["sigma"] * _NORMAL.inv_cdf(u))
        return int(min(max(int(v), law["min"]), law["max"]))
    raise ValueError(f"unknown length law {law['dist']!r}")


def mixture_quantile(mix: List[dict], u: float) -> int:
    """A mixture's value at ``u``: the component whose weight band holds
    ``u``, read at ``u``'s place inside that band."""
    total = sum(c["weight"] for c in mix)
    acc = 0.0
    for c in mix:
        w = c["weight"] / total
        if u < acc + w or c is mix[-1]:
            return quantile(c, min(max((u - acc) / w, 1e-12), 1 - 1e-12))
        acc += w
    raise AssertionError("unreachable")


def stratified(n: int, rng: np.random.Generator) -> np.ndarray:
    """The n stratified quantiles (i + 1/2) / n in an order drawn from
    ``rng``."""
    return rng.permutation((np.arange(n) + 0.5) / n)


def lengths(mix: List[dict], n: int, rng) -> List[int]:
    return [mixture_quantile(mix, float(u)) for u in stratified(n, rng)]


def make_requests(mix: dict, seed: int, seconds: float, vocab: int
                  ) -> Dict[str, object]:
    """The run's traffic: ``{"loop": ..., "clients": [[Request, ...], ...]}``
    for a closed loop, ``{"loop": ..., "arrivals": [Request, ...]}`` (by
    due time) for an open one."""
    loop = mix["loop"]
    ids = rng_for(seed, 1)
    if loop["kind"] == "closed":
        c, k = int(loop["clients"]), int(loop["requests_per_client"])
        steady = mix.get("steady_start")
        first = 1 if steady is not None else 0
        n = c * (k - first)
        p_len = lengths(mix["prompt"], n, rng_for(seed, 2))
        o_len = lengths(mix["output"], n, rng_for(seed, 3))
        if steady is not None:
            p_len = lengths(steady["context"], c, rng_for(seed, 4)) + p_len
            o_len = lengths(steady["residual"], c, rng_for(seed, 9)) + o_len
        clients = [[] for _ in range(c)]
        for j in range(k):
            for i in range(c):
                idx = j * c + i
                prompt = ids.integers(0, vocab, size=(p_len[idx],),
                                      dtype=np.int32)
                clients[i].append(Request(f"c{i}-{j}", prompt, o_len[idx],
                                          client=i))
        return {"loop": loop, "clients": clients}
    if loop["kind"] == "open":
        rate = float(loop["rate_rps"])
        n = max(1, int(round(rate * seconds)))
        gaps = [-math.log(1.0 - float(u)) / rate
                for u in stratified(n, rng_for(seed, 5))]
        burst = int(loop.get("burst_size", 1)) \
            if loop.get("arrivals", "poisson") == "burst" else 1
        spread = rng_for(seed, 6)
        due, t = [], 0.0
        for i in range(n):
            if i % burst == 0:
                t += gaps[i] * burst
            due.append(t + (spread.uniform(0, loop.get("burst_spread", 0.0))
                            if burst > 1 else 0.0))
        p_len = lengths(mix["prompt"], n, rng_for(seed, 2))
        o_len = lengths(mix["output"], n, rng_for(seed, 3))
        reqs = [Request(f"r{i}", ids.integers(0, vocab, size=(p_len[i],),
                                              dtype=np.int32),
                        o_len[i], due=due[i]) for i in range(n)]
        return {"loop": loop, "arrivals": sorted(reqs, key=lambda r: r.due)}
    raise ValueError(f"unknown loop kind {loop['kind']!r}")


def failures(mix: dict, seconds: float) -> List[dict]:
    """The mix's scripted failures, each with its time in the window."""
    return [dict(f, t=float(f["at"]) * seconds)
            for f in mix.get("failures", [])]


def warm_failover(mix: dict) -> Optional[dict]:
    return mix.get("warm_failover")
