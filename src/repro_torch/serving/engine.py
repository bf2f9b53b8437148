"""Tarragon inference engine (port of ``repro.serving.engine``): a thin
facade over the layered serving stack.

  * ``Gateway`` (serving/gateway.py): class queues and AW placement;
  * ``AttentionWorker`` / ``ExpertWorker`` (serving/workers.py): failure
    domains;
  * ``ContinuousBatchScheduler`` (serving/batching.py): bucketed padded
    prefill and the shared decode step.

The engine owns the device state (params, route state, the slot-partitioned
KV cache) on ``device`` ("cuda" unless the caller asks for "cpu").

Failure API of this slice: ``fail_ew(e)`` — EW e crashes and the ERT
resolves its experts to shadow slots on the next step; nothing else
changes. ``provision_ew(e)`` brings it back. The AW failure domain
(checkpoint streaming and per-request restore) arrives with its slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.refe import RouteState
from repro_torch.models import get_model
from repro_torch.serving.api import STANDARD, Client, SamplingParams
from repro_torch.serving.batching import ContinuousBatchScheduler
from repro_torch.serving.decode_loop import DecodeLoopPlane
from repro_torch.serving.gateway import Gateway, QueuedRequest
from repro_torch.serving.kvcache import CacheLayout
from repro_torch.serving.workers import AttentionWorker, ExpertWorker


@dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 96
    num_aw: int = 2
    num_ew: int = 2
    sample_seed: int = 0           # the engine's part of every draw's key


@dataclass
class RequestState:
    rid: str
    slot: int
    prompt: np.ndarray
    max_new: int
    tokens: List[int] = field(default_factory=list)  # generated tokens
    pos: int = 0                  # next position to write
    next_input: int = -1          # token the next decode step consumes
    done: bool = False
    cancelled: bool = False
    slo_class: str = STANDARD
    deadline: Optional[float] = None
    sampling: Optional[SamplingParams] = None
    t_enqueue: float = 0.0
    t_admit: float = -1.0
    t_first_token: float = -1.0
    t_done: float = -1.0
    _aw: int = -1

    @property
    def aw(self) -> int:
        return self._aw

    @property
    def state(self) -> str:
        if self.cancelled:
            return "cancelled"
        if self.done:
            return "done"
        return "decoding" if self.tokens else "placed"

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_enqueue \
            if self.t_first_token >= 0 else -1.0


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig, *,
                 params: Optional[dict] = None, seed: int = 0,
                 device="cuda"):
        """``params`` (e.g. converted from the reference) or, when None,
        the port's own seeded init drawn on ``device``."""
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = torch.device(device)
        self.api = get_model(cfg, num_aw=ecfg.num_aw, num_ew=ecfg.num_ew,
                             device=self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.api.init_params(gen)
        self.params = params
        self.route_state: RouteState = self.api.init_route_state()
        if ecfg.max_batch % ecfg.num_aw:
            raise ValueError("max_batch must be a multiple of num_aw")
        self.cache = self.api.init_cache(ecfg.max_batch, ecfg.max_seq)
        self.layout = CacheLayout()
        self.prefill_paddable = self.layout.prefill_paddable(
            self.cache, ecfg.max_seq)

        per_aw = ecfg.max_batch // ecfg.num_aw
        self.aws = [AttentionWorker(a, a * per_aw, (a + 1) * per_aw)
                    for a in range(ecfg.num_aw)]
        self.ews = [ExpertWorker(e) for e in range(ecfg.num_ew)]

        self.gateway = Gateway(self.aws)
        self.scheduler = ContinuousBatchScheduler(self, self.gateway)
        self.decode_plane = DecodeLoopPlane(self)
        self.requests: Dict[str, RequestState] = {}
        self._release_hooks: List[Callable] = []
        self._client: Optional[Client] = None
        self.steps = 0

    # -- expert capacity ----------------------------------------------------
    def prefill_capacity(self, n_real_tokens: int) -> Optional[int]:
        """Capacity of a prefill call from its REAL token count, rounded
        up to a power of two."""
        if not self.cfg.moe.enabled:
            return None
        cap = int(max(1, round(self.cfg.moe.capacity_factor *
                               self.cfg.moe.top_k * n_real_tokens /
                               self.cfg.moe.num_experts)))
        p = 1
        while p < cap:
            p *= 2
        return p

    # -- admission ----------------------------------------------------------
    def make_request_state(self, q: QueuedRequest, slot: int
                           ) -> RequestState:
        st = RequestState(rid=q.rid, slot=slot, prompt=q.prompt,
                          max_new=q.max_new, t_enqueue=q.t_enqueue,
                          slo_class=q.slo_class, deadline=q.deadline,
                          sampling=q.sampling)
        self.decode_plane.bind(st)
        return st

    @property
    def client(self) -> Client:
        """The typed request API's front door."""
        if self._client is None:
            self._client = Client(self)
        return self._client

    def add_release_hook(self, fn: Callable):
        self._release_hooks.append(fn)

    # -- decode -------------------------------------------------------------
    def active_requests(self) -> List[RequestState]:
        return [r for r in self.requests.values() if not r.done]

    def step(self, now: Optional[float] = None) -> Dict[str, List[int]]:
        """One iteration: admission when anything waits, then one decode
        step over all active slots. Returns {rid: new_tokens}."""
        return self.scheduler.step(now)

    # -- failures -----------------------------------------------------------
    @property
    def failed_ews(self) -> set:
        return {w.ew_id for w in self.ews if w.member and not w.alive}

    def fail_ew(self, ew: int):
        self.route_state = self.ews[ew].fail(self.route_state)

    def provision_ew(self, ew: int):
        self.route_state = self.ews[ew].provision(self.route_state)

    # -- teardown -----------------------------------------------------------
    def cancel_request(self, rid: str, now: float = 0.0) -> bool:
        r = self.requests.get(rid)
        if r is None:
            return self.gateway.drop(rid) is not None
        if r.done:
            return False
        r.cancelled = True
        r.done = True
        self.release_request(rid)
        return True

    def release_request(self, rid: str):
        """Free one request's slot and cache rows."""
        r = self.requests.pop(rid, None)
        if r is None:
            return
        if r._aw >= 0 and self.aws[r._aw].alive:
            self.layout.clear_slot(self.cache, r.slot)
            self.aws[r._aw].slots.release(r.slot)
        for hook in self._release_hooks:
            hook(r)
