"""Typed client-facing request API (port of ``repro.serving.api``):
SLO classes, ``RequestSpec``, ``Client`` and ``RequestHandle``.

``Client.submit`` enqueues into the Gateway's class queues and runs one
admission pass; it never refuses. ``RequestHandle`` observes one request:
``status()`` over the lifecycle queued -> placed -> decoding -> done (or
cancelled), incremental ``new_tokens()``, and ``cancel()``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

INTERACTIVE = "interactive"
STANDARD = "standard"
BATCH = "batch"

#: admission priority order (also the weighted-dequeue service order)
SLO_CLASSES = (INTERACTIVE, STANDARD, BATCH)

#: per-class weighted-dequeue credits per admission round
CLASS_WEIGHTS = {INTERACTIVE: 4, STANDARD: 2, BATCH: 1}


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode head configuration."""
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0                 # 0 = full distribution (greedy=False)
    seed: Optional[int] = None     # None = a stable hash of the rid


@dataclass
class RequestSpec:
    """Typed request description. ``prompt`` may be left None with
    (``prompt_len``, ``seed``, ``token_dist``) set; the client then draws
    it as the reference's workload generator does."""
    rid: Optional[str] = None      # auto-assigned by the Client when None
    prompt: Optional[np.ndarray] = None
    max_new: int = 16
    sampling: Optional[SamplingParams] = None
    slo_class: str = STANDARD
    deadline: Optional[float] = None   # first-token deadline: orders the
    #                                    class queue (earlier first)
    prompt_len: int = 8
    seed: int = 0
    token_dist: str = "uniform"    # "uniform" | "zipf"
    zipf_a: float = 1.3

    def __post_init__(self):
        if self.slo_class not in SLO_CLASSES:
            raise ValueError(
                f"unknown slo_class {self.slo_class!r}: "
                f"expected one of {SLO_CLASSES}")

    def resolve_prompt(self, vocab: int) -> np.ndarray:
        if self.prompt is not None:
            return np.asarray(self.prompt, np.int32)
        rng = np.random.default_rng(self.seed)
        if self.token_dist == "zipf":
            toks = rng.zipf(self.zipf_a, size=(self.prompt_len,)) - 1
            return (toks % vocab).astype(np.int32)
        if self.token_dist != "uniform":
            raise ValueError(f"unknown token_dist {self.token_dist!r}")
        return rng.integers(0, vocab, size=(self.prompt_len,),
                            dtype=np.int32)


QUEUED = "queued"
PLACED = "placed"
DECODING = "decoding"
DONE = "done"
CANCELLED = "cancelled"


@dataclass
class RequestStatus:
    """Point-in-time snapshot of one request's lifecycle."""
    rid: str
    state: str
    slo_class: str = STANDARD
    tokens_generated: int = 0
    deadline: Optional[float] = None
    ttft: float = -1.0


class RequestHandle:
    """Observe and steer one submitted request. The final RequestState is
    pinned onto the handle at release, so results stay readable."""

    def __init__(self, client: "Client", spec: RequestSpec):
        self._client = client
        self._engine = client.engine
        self.spec = spec
        self.rid: str = spec.rid
        self._state = None
        self._cancelled = False
        self._stream_cursor = 0

    def _lookup(self):
        if self._state is not None and \
                (self._state.done or self._state.cancelled):
            return self._state
        r = self._engine.requests.get(self.rid)
        if r is not None:
            self._state = r
        return self._state

    def state(self) -> str:
        r = self._lookup()
        if r is None:
            if self._cancelled:
                return CANCELLED
            return QUEUED if self._engine.gateway.find(self.rid) is not None \
                else DONE
        return r.state

    def status(self) -> RequestStatus:
        r = self._lookup()
        st = RequestStatus(self.rid, self.state(),
                           slo_class=self.spec.slo_class,
                           deadline=self.spec.deadline)
        if r is not None:
            st.tokens_generated = len(r.tokens)
            st.ttft = r.ttft
        return st

    def tokens(self) -> List[int]:
        r = self._lookup()
        return list(r.tokens) if r is not None else []

    def new_tokens(self) -> List[int]:
        """Tokens generated since the last call."""
        toks = self.tokens()
        self._stream_cursor = min(self._stream_cursor, len(toks))
        out = toks[self._stream_cursor:]
        self._stream_cursor = len(toks)
        return out

    def done(self) -> bool:
        return self.state() in (DONE, CANCELLED)

    def cancel(self, now: float = 0.0) -> bool:
        ok = self._engine.cancel_request(self.rid, now=now)
        if ok:
            self._cancelled = True
        return ok

    def __repr__(self):
        return f"RequestHandle({self.rid!r}, state={self.state()!r})"


class Client:
    """Front door of the typed request API."""

    def __init__(self, engine):
        self.engine = engine
        self._handles: Dict[str, RequestHandle] = {}
        self._auto_rid = 0
        engine.add_release_hook(self._on_release)

    def _on_release(self, rstate):
        h = self._handles.get(rstate.rid)
        if h is not None:
            h._state = rstate

    def _next_rid(self) -> str:
        self._auto_rid += 1
        return f"req-{self._auto_rid}"

    def submit(self, spec: RequestSpec, now: float = 0.0) -> RequestHandle:
        if spec.rid is None:
            spec = dataclasses.replace(spec, rid=self._next_rid())
        live = self.engine.requests.get(spec.rid)
        if (live is not None and not live.done) or \
                self.engine.gateway.find(spec.rid) is not None:
            raise ValueError(f"request id {spec.rid!r} already in flight")
        if live is not None:
            # rid reuse after completion: free the finished request first
            self.engine.release_request(spec.rid)
        prompt = spec.resolve_prompt(self.engine.cfg.vocab_size)
        self.engine.gateway.enqueue(
            spec.rid, prompt, spec.max_new, now=now,
            slo_class=spec.slo_class, deadline=spec.deadline,
            sampling=spec.sampling)
        handle = RequestHandle(self, spec)
        self._handles[spec.rid] = handle
        self.engine.scheduler.admit(now)
        return handle

    def handle(self, rid: str) -> Optional[RequestHandle]:
        return self._handles.get(rid)

    def cancel(self, rid: str, now: float = 0.0) -> bool:
        h = self._handles.get(rid)
        if h is not None:
            return h.cancel(now=now)
        return self.engine.cancel_request(rid, now=now)
