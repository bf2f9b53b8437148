"""Tarragon inference engine (port of ``repro.serving.engine``): a thin
facade over the layered serving stack.

  * ``Gateway`` (serving/gateway.py): class queues and AW placement;
  * ``AttentionWorker`` / ``ExpertWorker`` (serving/workers.py): failure
    domains;
  * ``ContinuousBatchScheduler`` (serving/batching.py): bucketed padded
    prefill, per-request restoration and the shared decode step;
  * ``ChunkedPrefillPlane`` (serving/chunked.py): budgeted, resumable
    prefill, when ``chunk_token_budget`` > 0;
  * ``DecodeLoopPlane`` (serving/decode_loop.py): the decode step, or a
    segment of ``decode_segment_len`` steps, and its sampling; on the
    card each is one replay of a captured CUDA graph.

The engine owns the device state (params, route state, the KV cache:
contiguous per slot, or paged through block tables when
``kv_page_tokens`` > 0) on ``device`` ("cuda" unless the caller asks for
"cpu"), and the CheckpointStore every AW streams its KV writes to.

Failure API:
  * ``fail_aw(a)``: AW a crashes; its slots, pages and undelivered
    checkpoint writes are lost and its requests pause.
    ``recover_aw_requests()`` requeues them at the front of the Gateway
    and admits what fits; each is restored per request from the store
    onto a healthy slot (§6.2). ``provision_aw(a)`` brings the AW back.
  * ``fail_ew(e)``: EW e crashes and the ERT resolves its experts to
    shadow slots on the next step; nothing else changes.
    ``provision_ew(e, repoint_protect=f)`` brings it back and re-points
    the shadow slots to protect EW f.

Request plane: a blocked interactive head may preempt a batch victim
(``preempt``, ``victim_policy``): the victim's resident KV is committed to
the store through the bulk range path, its slot freed, and it re-enters
the Gateway as a recovery entry that resumes from its cursor.
``check_deadlines`` flags first-token and completion deadline misses; the
lifecycle events (``preempted``, ``cancelled``, ``deadline_missed``) come
out of ``drain_request_events``.

Prefix-cache plane (``serving/prefixcache.py``, ``prefix_cache_slots`` >
0, chunked prefill only): a finished request's slot (contiguous) or pages
(paged) are offered to its AW's radix cache with its store log; a later
prompt sharing a prefix adopts them and prefills only the tail. A dead
AW's cached prefixes are restored from the store onto healthy AWs.

Telemetry plane (``serving/telemetry.py``, ``telemetry`` True by default,
as in the reference): every worker, placement and request-plane event is
published on ``engine.bus``; ``engine.telemetry`` keeps histograms,
spans and stall attribution from host hooks on values the host already
holds (no device read, no capture).

Control plane (``serving/controller.py``, ``controller="on"``): one
decision pass per tick autoscales the EW pool, triggers weighted
rebalances off the load trajectory, adapts the chunk budget to deadline
headroom and, under ``victim_policy="controller"``, gates preemption on
deadline risk. Forensics plane (``serving/flightrec.py``,
``flight_recorder`` True by default, as in the reference): a bounded
recorder of events, submissions, outputs and state fingerprints on the
bus, postmortem bundles that ``launch/replay.py`` re-runs, and health
watchdogs (``watchdogs``). Both planes read host state only.

Placement plane (``core/placement.py``): with MoE and ``tarragon``, an
``ExpertPlacementManager`` versions the expert layout. ``add_ew``,
``drain_ew``, ``promote_shadows``, ``rebalance`` and ``repoint_shadows``
each install a plan generation, a RouteState update of fixed shapes (the
EW-health mask is sized for ``max_ew`` at start), so no step graph is
captured anew. The steps' per-slot dispatch loads feed the manager's EMAs
(``note_dispatch_load``), which choose the EW to protect and drive
load-aware rebalancing.

``tarragon=False, checkpoint=False`` is the MegaScale-Infer-style
baseline: no shadow slots and no checkpoint store, so a failed EW's
experts are unreachable and a failed AW's requests cannot be restored
(they keep decoding against the dead worker's slot, as in the
reference).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.checkpoint import CheckpointStore
from repro_torch.core.orchestrator import WorkerEvent
from repro_torch.core.placement import ExpertPlacementManager, PlacementPlan
from repro_torch.core.refe import RouteState
from repro_torch.models import get_model
from repro_torch.models.attention import PREFILL_BLOCK_K
from repro_torch.serving.api import (CANCELLED, DECODING, DONE, PLACED,
                                     PREEMPTED, PREEMPTIBLE_CLASSES,
                                     PREFILLING, STANDARD, Client,
                                     RequestSpec, SamplingParams)
from repro_torch.serving.batching import ContinuousBatchScheduler
from repro_torch.serving.chunked import ChunkedPrefillPlane
from repro_torch.serving.controller import ServingController
from repro_torch.serving.decode_loop import (DecodeLoopPlane,
                                             _sample_tokens)
from repro_torch.serving.flightrec import FlightRecorder
from repro_torch.serving.gateway import Gateway, QueuedRequest
from repro_torch.serving.kvcache import (CacheLayout, PagedCacheLayout,
                                         PagePool, state_leaves)
from repro_torch.serving.prefixcache import PrefixCachePlane
from repro_torch.serving.telemetry import EventBus, TelemetryPlane
from repro_torch.serving.workers import (AttentionWorker, ClusterSlotView,
                                         ExpertWorker)


@dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 96
    num_aw: int = 2
    num_ew: int = 2
    max_ew: int = 0                # elastic EW pool ceiling (spare EW ids
    #                                a scale-out can admit; 0 = num_ew)
    tarragon: bool = True          # False = MegaScale-style static binding
    #                                (no shadow slots)
    checkpoint: bool = True        # False = nothing reaches the store
    checkpoint_reorder: int = 0    # test hook: each AW's checkpointer
    #                                delivers its segments shuffled in
    #                                windows of this many
    greedy: bool = True            # the sampling of a request that carries
    temperature: float = 1.0       # no SamplingParams (temperature and
    top_k: int = 0                 # top_k when greedy is False; top_k 0 =
    #                                the full distribution)
    sample_seed: int = 0           # the engine's part of every draw's key
    capacity_factor_decode: float = 0.0  # decode steps' expert capacity
    #                                factor over max_batch rows (0 = the
    #                                model's own capacity factor)
    placement: str = "least_loaded"      # Gateway placement policy
    prefill_bucket: int = 16       # padded-prefill length bucket
    kv_page_tokens: int = 0        # KV page extent in tokens (0 = the
    #                                contiguous per-slot cache; > 0 needs
    #                                full attention, chunked prefill and
    #                                must divide max_seq)
    chunk_token_budget: int = 0    # real prefill tokens per tick (0 =
    #                                whole-prompt prefill; a family that
    #                                cannot be padded ignores it)
    prefill_token_cap: int = 0     # Gateway cap on prompt tokens admitted
    #                                but not yet prefilled (0 = slot-bound
    #                                admission only)
    preempt: bool = True           # a blocked interactive head may evict a
    #                                batch victim (preempt-and-requeue)
    victim_policy: str = "remaining_work"  # "remaining_work" (most tokens
    #                                left, prefill debt included),
    #                                "youngest" (latest arrival) or
    #                                "controller" (the control plane's
    #                                deadline- and KV-aware choice; needs
    #                                controller="on")
    decode_segment_len: int = 1    # decode steps per dispatch (one CUDA
    #                                graph replay on the card); > 1 drains
    #                                the tokens once per segment and
    #                                checkpoints the segment through the
    #                                bulk range path, so a failure
    #                                mid-segment rewinds at most this many
    #                                tokens (the transformer family only)
    # ---- prefix-cache plane (serving/prefixcache.py)
    prefix_cache_slots: int = 0    # per-AW cached-prefix slot budget (0 =
    #                                plane off; needs chunked prefill)
    prefix_cache_tokens: int = 0   # per-AW cached-token budget (0 = slots
    #                                only)
    prefix_min_match: int = 4      # shortest prefix worth adopting
    prefix_restore: bool = True    # restore a dead AW's cached prefixes
    #                                from the store onto healthy AWs
    kv_pages: int = 0              # per-AW physical page budget (0 = the
    #                                contiguous footprint, slots x blocks)
    prefix_global_index: bool = False  # one cluster-wide radix index routes
    #                                arrivals to their best-match AW (paged)
    prefix_migrate: bool = False   # replay a hot prefix onto a free AW when
    #                                its home cannot take the hit (paged)
    # ---- telemetry plane (serving/telemetry.py)
    telemetry: bool = True         # metrics, spans and stall attribution
    #                                (host only: on and off give the same
    #                                streams and step graphs)
    stall_threshold: float = 0.25  # TTFT/TBT gap (virtual s) above which
    #                                the gap is attributed to causes
    hist_buckets_per_decade: int = 32  # streaming-histogram resolution
    trace_export_path: str = ""    # Chrome trace written at finalize
    # ---- control plane (serving/controller.py)
    controller: str = "off"        # "off" (every knob static) or "on"
    #                                (one decision pass per tick; host
    #                                only: on equals its decisions replayed
    #                                as a script, bit for bit)
    ctl_autoscale: bool = True     # policy 1: EW pool size from queue-depth
    #                                EMA watermarks
    ctl_rebalance: bool = True     # policy 2: trajectory-triggered
    #                                rebalance and weighted split plans
    ctl_chunk_budget: bool = True  # policy 3: chunk budget from SLO
    #                                headroom
    ctl_queue_high: float = 3.0    # scale-out watermark (queue EMA)
    ctl_queue_low: float = 0.25    # scale-in watermark (queue EMA; the
    #                                pool must also be idle and above its
    #                                boot size)
    ctl_scale_dwell: float = 0.0   # debounce between scale decisions (0 =
    #                                T_w + 2*T_push of the orchestrator)
    ctl_headroom: float = 0.25     # interactive deadline headroom (virtual
    #                                s) under which the budget reacts
    ctl_budget_min: int = 0        # budget floor (0 = max(min_chunk,
    #                                base/4))
    ctl_budget_max: int = 0        # budget ceiling (0 = 4x the base)
    ctl_deadline_risk: float = 0.1  # head deadline headroom (virtual s)
    #                                below which the preemption gate opens
    #                                (victim_policy="controller")
    ctl_kv_weight: float = 1.0     # victim pricing: weight of the resident
    #                                or exclusive KV subtracted from the
    #                                remaining work
    # ---- forensics plane (serving/flightrec.py)
    flight_recorder: bool = True   # black box riding the EventBus (host
    #                                only: on and off give the same streams
    #                                and step graphs)
    flight_capacity: int = 4096    # ring size of records, submissions and
    #                                outputs (older drop, drops counted)
    flight_fingerprint_every: float = 0.5  # virtual s between engine-state
    #                                fingerprints (0 = only on dump)
    flight_autodump: str = ""      # write a bundle here on the first
    #                                failure detection or watchdog trip
    watchdogs: bool = False        # leak, stall-regression and invariant
    #                                detectors (need the recorder)
    wd_interval: float = 0.25      # watchdog interval (virtual s)
    wd_window: int = 8             # sliding window (intervals) of the
    #                                trend tests
    wd_leak_min_drop: int = 2      # free-list watermark drop over a full
    #                                window that counts as a leak
    wd_stall_factor: float = 2.0   # windowed TTFT/TBT p99 multiple of the
    #                                baseline that trips
    wd_settle: float = 1.0         # quiet time after a disturbance before
    #                                leak and stall judgments resume


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
    paused: bool = False          # owning AW died; awaiting re-admission
    queued_for_recovery: bool = False
    prefilling: bool = False      # prompt still streaming through the
    #                               chunked-prefill plane (no decode yet)
    prefill_cursor: int = 0       # prompt tokens already written to cache
    cancelled: bool = False
    slo_class: str = STANDARD
    deadline: Optional[float] = None   # first-token deadline
    completion_deadline: Optional[float] = None  # last-token deadline
    deadline_flagged: bool = False     # deadline_missed already emitted
    completion_flagged: bool = False   # completion overrun already emitted
    preemptions: int = 0               # planned evictions survived
    prefix_hit: int = 0                # prompt tokens adopted from the
    #                                    prefix cache at admission
    sampling: Optional[SamplingParams] = None
    session: Optional[str] = None
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
        """queued -> placed -> prefilling -> decoding -> done (or
        cancelled); "preempted" while it waits for restoration, after its
        AW died or a preemption evicted it (queued is before a
        RequestState exists)."""
        if self.cancelled:
            return CANCELLED
        if self.done:
            return DONE
        if self.paused or self.queued_for_recovery:
            return PREEMPTED
        if self.prefilling:
            return PREFILLING
        return DECODING if self.tokens else PLACED

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
                             tarragon=ecfg.tarragon, device=self.device)
        # how the weights were made, pinned so a postmortem bundle can
        # rebuild this engine: the seed of the engine's own draw, or None
        # for weights the caller passed in (a replay then needs them)
        self.weights_source: Optional[dict] = None
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.api.init_params(gen)
            self.weights_source = {"seed": int(seed)}
        self.params = params
        self.route_state: RouteState = self.api.init_route_state()
        if ecfg.max_batch % ecfg.num_aw:
            raise ValueError("max_batch must be a multiple of num_aw")
        if ecfg.victim_policy not in ("remaining_work", "youngest",
                                      "controller"):
            raise ValueError(f"unknown victim_policy {ecfg.victim_policy!r}")
        if ecfg.controller not in ("off", "on"):
            raise ValueError(f"unknown controller mode {ecfg.controller!r}")
        if ecfg.victim_policy == "controller" and ecfg.controller != "on":
            raise ValueError('victim_policy="controller" needs the control '
                             'plane (controller="on")')
        if ecfg.watchdogs and not ecfg.flight_recorder:
            raise ValueError("watchdogs=True needs flight_recorder=True "
                             "(the watchdogs ride the recorder's bus "
                             "cursor and trigger its dump)")
        if ecfg.decode_segment_len > 1 and \
                not self.api.supports_decode_segments:
            raise ValueError(
                f"decode_segment_len={ecfg.decode_segment_len} needs a "
                f"model family whose decode step can run past a row's end "
                f"(the transformer family); {cfg.name} does not support it")
        # ---- KV plane: contiguous per-slot cache, or paged block tables.
        # Paged mode swaps the layout, not the model: the per-layer pools
        # are the contiguous cache built with batch = pages, max_seq =
        # page_tokens, plus one [B, nblk] block table.
        self.pages: Optional[PagePool] = None
        if ecfg.kv_page_tokens > 0:
            pt = ecfg.kv_page_tokens
            if state_leaves(self.api.init_cache(1, pt)):
                # the reference's paged layout asserts an attention-only
                # cache: state leaves (recurrent state, cross K/V) have no
                # pages
                raise ValueError("paged KV needs an attention-only cache "
                                 f"({cfg.name} keeps state leaves)")
            if ecfg.max_seq % pt:
                raise ValueError(f"kv_page_tokens={pt} must divide "
                                 f"max_seq={ecfg.max_seq}")
            if cfg.sliding_window:
                raise ValueError("paged KV needs full attention in every "
                                 "layer (no sliding window)")
            if ecfg.chunk_token_budget <= 0:
                # the reference's paged engine runs only with chunked
                # prefill: its whole-prompt path reads the paged cache
                # through the contiguous layout and fails
                raise ValueError("paged KV needs chunked prefill "
                                 "(chunk_token_budget > 0)")
            self.pages = PagePool(ecfg.max_batch, ecfg.num_aw,
                                  ecfg.max_seq // pt, pt,
                                  pages_per_aw=ecfg.kv_pages)
            self.layout = PagedCacheLayout(self.pages, ecfg.max_seq)
            self.cache = self.layout.make_cache(self.api.init_cache,
                                                ecfg.max_batch)
        else:
            self.layout = CacheLayout()
            self.cache = self.api.init_cache(ecfg.max_batch, ecfg.max_seq)
        if self.pages is None and (ecfg.prefix_global_index or
                                   ecfg.prefix_migrate):
            raise ValueError("prefix_global_index and prefix_migrate need "
                             "the paged KV plane (kv_page_tokens > 0)")
        self.prefill_paddable = self.layout.prefill_paddable(
            self.cache, ecfg.max_seq)
        self.store = CheckpointStore()

        per_aw = ecfg.max_batch // ecfg.num_aw
        self.aws = [AttentionWorker(a, a * per_aw, (a + 1) * per_aw,
                                    self.store,
                                    reorder_window=ecfg.checkpoint_reorder)
                    for a in range(ecfg.num_aw)]
        for w in self.aws:
            w.page_pool = self.pages
        max_ew = max(ecfg.max_ew or ecfg.num_ew, ecfg.num_ew)
        self.ews = [ExpertWorker(e, member=e < ecfg.num_ew)
                    for e in range(max_ew)]
        self.slots = ClusterSlotView(self.aws, ecfg.max_batch)

        # ---- placement plane: versioned plans and load EMAs. The EW-health
        # mask is sized for max_ew now, so a scale-out changes no tensor's
        # shape (the step graphs copy into RouteState tensors they hold)
        self.placement_mgr: Optional[ExpertPlacementManager] = None
        self.plan_log: List[WorkerEvent] = []
        if ecfg.tarragon and self.api.placement is not None:
            self.placement_mgr = ExpertPlacementManager(
                self.api.placement, ecfg.num_ew, max_ew=max_ew)
            self.route_state = self.route_state._replace(
                ew_health=torch.as_tensor(
                    self.placement_mgr.ew_member_mask(), dtype=torch.bool,
                    device=self.device),
                **self._plan_arrays(self.placement_mgr.plan))
        self.collect_load = self.placement_mgr is not None

        self.gateway = Gateway(self.aws, policy=ecfg.placement)
        self.scheduler = ContinuousBatchScheduler(
            self, self.gateway, bucket=ecfg.prefill_bucket)
        # ---- telemetry plane: the event bus always runs (it is the audit
        # stream); the TelemetryPlane when ``telemetry`` is on
        self.bus = EventBus()
        self.gateway.attach_bus(self.bus)
        self.telemetry: Optional[TelemetryPlane] = \
            TelemetryPlane(self) if ecfg.telemetry else None
        self.gateway.telemetry = self.telemetry
        self.decode_plane = DecodeLoopPlane(self)
        # chunked streams need slot == absolute position and no recurrent
        # state (a padded cache); other families keep the whole-prompt
        # path, as in the reference
        self.chunked: Optional[ChunkedPrefillPlane] = None
        if ecfg.chunk_token_budget > 0 and self.prefill_paddable:
            # chunked == whole-prompt bits need one KV block partition:
            # the cache extent and the padded buckets both multiples of
            # the prefill's key block
            if ecfg.max_seq % PREFILL_BLOCK_K or \
                    ecfg.prefill_bucket % PREFILL_BLOCK_K:
                raise ValueError(
                    f"chunked prefill requires max_seq and prefill_bucket "
                    f"to be multiples of PREFILL_BLOCK_K={PREFILL_BLOCK_K} "
                    f"(got max_seq={ecfg.max_seq}, prefill_bucket="
                    f"{ecfg.prefill_bucket})")
            self.chunked = ChunkedPrefillPlane(self, ecfg.chunk_token_budget)
            self.gateway.prefill_load = self.chunked.outstanding_tokens
        self.gateway.prefill_token_cap = ecfg.prefill_token_cap
        # ---- prefix-cache plane: adoption is a mid-prompt start of the
        # chunk stream, so it needs the chunked plane
        self.prefix_plane: Optional[PrefixCachePlane] = None
        if ecfg.prefix_cache_slots > 0:
            if self.chunked is None:
                raise ValueError(
                    "prefix_cache_slots > 0 needs the chunked-prefill plane "
                    "(chunk_token_budget > 0 on a full-attention family)")
            self.prefix_plane = PrefixCachePlane(
                self, ecfg.prefix_cache_slots, ecfg.prefix_cache_tokens,
                min_match=ecfg.prefix_min_match)
        elif ecfg.prefix_global_index or ecfg.prefix_migrate:
            raise ValueError("prefix_global_index and prefix_migrate need "
                             "the prefix-cache plane (prefix_cache_slots "
                             "> 0)")
        if ecfg.preempt:
            self.gateway.preemptor = self._preempt_for
        self.request_log: List[WorkerEvent] = []
        self.requests: Dict[str, RequestState] = {}
        self._release_hooks: List[Callable] = []
        self._client: Optional[Client] = None
        self.steps = 0
        # ---- control plane: one decision pass per tick over host signals
        # the stack already keeps, acting through existing mechanisms
        self.controller: Optional[ServingController] = \
            ServingController(self) if ecfg.controller == "on" else None
        # ---- forensics plane: bounded black box and health watchdogs on
        # the bus, host bookkeeping only
        self.flightrec: Optional[FlightRecorder] = \
            FlightRecorder(self) if ecfg.flight_recorder else None
        self.gateway.flightrec = self.flightrec

    # -- expert capacity ----------------------------------------------------
    @property
    def decode_capacity(self) -> Optional[int]:
        """A decode step's expert capacity from ``capacity_factor_decode``
        over ``max_batch`` rows (None: the model's capacity factor)."""
        cf = self.ecfg.capacity_factor_decode
        if not cf or not self.cfg.moe.enabled:
            return None
        return int(max(1, round(cf * self.cfg.moe.top_k *
                                self.ecfg.max_batch /
                                self.cfg.moe.num_experts)))

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

    # -- host sampling: the decode head samples on the device
    # (``decode_plane``); this shim remains for callers holding host logits
    def sample_token(self, row_logits: np.ndarray,
                     sampling: Optional[SamplingParams] = None, *,
                     seed: Optional[int] = None, pos: int = 0) -> int:
        """DEPRECATED host-side sampling shim: the decode head's own sampler
        on one CPU row, float32, keyed on (the engine's ``sample_seed``,
        ``seed`` (0 if None), ``pos``): no RNG state, the same draw for the
        same (seed, pos), and the decode loop's distribution and bits."""
        ecfg = self.ecfg
        sp = SamplingParams(greedy=ecfg.greedy, temperature=ecfg.temperature,
                            top_k=ecfg.top_k) if sampling is None else sampling
        logits = torch.as_tensor(np.asarray(row_logits, np.float32))[None]
        out = _sample_tokens(
            ecfg.sample_seed, logits, torch.tensor([pos], dtype=torch.int32),
            torch.tensor([bool(sp.greedy)]),
            torch.tensor([float(sp.temperature)], dtype=torch.float32),
            torch.tensor([int(sp.top_k)], dtype=torch.int32),
            torch.tensor([0 if seed is None else int(seed)],
                         dtype=torch.int64),
            deep_k=int(sp.top_k) > 64)
        return int(out[0])

    def choose_aw(self) -> Optional[int]:
        """The Gateway's placement pick for a request with no key."""
        return self.gateway.choose_aw()

    # -- admission ----------------------------------------------------------
    def make_request_state(self, q: QueuedRequest, slot: int
                           ) -> RequestState:
        st = RequestState(rid=q.rid, slot=slot, prompt=q.prompt,
                          max_new=q.max_new, t_enqueue=q.t_enqueue,
                          slo_class=q.slo_class, deadline=q.deadline,
                          completion_deadline=q.completion_deadline,
                          sampling=q.sampling, session=q.session,
                          prefix_hit=q.prefix_hit,
                          # a miss flagged while queued is not flagged again
                          deadline_flagged=q.deadline_flagged,
                          completion_flagged=q.completion_flagged)
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
        return [r for r in self.requests.values()
                if not r.done and not r.paused and not r.prefilling]

    def prefilling_requests(self) -> List[RequestState]:
        return [r for r in self.requests.values()
                if r.prefilling and not r.done and not r.paused]

    def step(self, now: Optional[float] = None) -> Dict[str, List[int]]:
        """One iteration: admission when anything waits, then one decode
        step over all active slots. Returns {rid: new_tokens}."""
        return self.scheduler.step(now)

    # -- prefill accounting (the serving loop's clock and metrics) -----------
    def prefill_tokens_done(self) -> int:
        """Real prompt tokens prefilled so far, whole-prompt and chunked."""
        n = self.scheduler.stats.real_tokens
        if self.chunked is not None:
            n += self.chunked.stats.real_tokens
        return n

    def prefill_snapshot(self) -> dict:
        snap = self.scheduler.stats.snapshot()
        if self.chunked is not None:
            snap["chunked"] = self.chunked.stats.snapshot()
        return snap

    # -- request lifecycle: preemption, cancellation, deadlines. A
    # preempted request is checkpointed out of its slot and re-enters
    # exactly as a crash-recovered one does.
    def _note_request_event(self, kind: str, rid: str, now: float,
                            detail: str = ""):
        ev = WorkerEvent(now, kind, rid, detail)
        self.request_log.append(ev)
        # published at emission for every cursor-based consumer
        self.bus.publish(ev)
        if self.telemetry is not None:
            self.telemetry.on_request_event(ev)

    def drain_request_events(self) -> List[WorkerEvent]:
        """Request-plane events since the last drain: ``preempted``,
        ``cancelled`` and ``deadline_missed``, then the placement policy's
        ``session_repinned``."""
        evs, self.request_log = self.request_log, []
        return evs + self.gateway.drain_events()

    @staticmethod
    def _remaining_work(r: RequestState) -> int:
        """Decode tokens still owed plus the prefill debt (prompt tokens
        not prefilled yet): a mid-prefill request has invested little and
        is the cheapest to push aside."""
        debt = (len(r.prompt) - 1 - r.prefill_cursor) if r.prefilling else 0
        return (r.max_new - len(r.tokens)) + debt

    def _choose_victim(self, exclude: str = "", head=None,
                       now: float = 0.0) -> Optional[RequestState]:
        """The preemption victim among preemptible-class requests resident
        on live AWs: the most remaining work (``remaining_work``) or the
        latest arrival (``youngest``); among equals the one preempted the
        fewest times, then the highest rid. ``controller`` delegates to
        the control plane, which evicts only when the blocked head's
        deadline is at risk and prices in the victim's exclusive KV and
        adopted prefix. The candidate filter is shared, so interactive
        work is never a victim."""
        cands = [r for r in self.requests.values()
                 if r.slo_class in PREEMPTIBLE_CLASSES and not r.done
                 and not r.paused and not r.cancelled
                 and not r.queued_for_recovery and r.rid != exclude
                 and r._aw >= 0 and self.aws[r._aw].alive]
        if not cands:
            return None
        if self.ecfg.victim_policy == "controller":
            return self.controller.choose_victim(cands, head=head, now=now)
        if self.ecfg.victim_policy == "youngest":
            return max(cands, key=lambda r: (r.t_enqueue, -r.preemptions,
                                             r.rid))
        return max(cands, key=lambda r: (self._remaining_work(r),
                                         -r.preemptions, r.rid))

    def _preempt_for(self, head: QueuedRequest, now: float) -> bool:
        """The Gateway's preemptor: a blocked interactive head asks for a
        slot; evict a batch victim if there is one."""
        victim = self._choose_victim(exclude=head.rid, head=head, now=now)
        if victim is None:
            return False
        return self.preempt_request(victim.rid, now=now)

    def preempt_request(self, rid: str, now: float = 0.0) -> bool:
        """Planned eviction (preempt-and-requeue): commit the victim's
        resident KV to the store, release its slot and requeue it as a
        recovery entry at the front of its class queue. On re-admission it
        restores the committed prefix and resumes from the cursor: a
        decoding request rewinds zero tokens (the watermark is flushed
        first), a chunked prefill resumes mid-prompt. No health mask
        changes and no step graph is captured."""
        r = self.requests.get(rid)
        if r is None or r.done or r.paused or r.cancelled or \
                r.queued_for_recovery or r._aw < 0:
            return False
        aw = self.aws[r._aw]
        if not aw.alive:
            return False
        committed = self._commit_resident_kv(r)
        if self.chunked is not None:
            self.chunked.drop(rid)
        if self.prefix_plane is not None:
            # an adopted prefix entry cannot outlive the eviction: the slot
            # is cleared below (the victim's own log has what it resumes
            # from)
            self.prefix_plane.forget_slot(r._aw, r.slot)
        self._kv_clear_slot(r.slot)
        aw.slots.release(r.slot)
        r.paused = True
        r.queued_for_recovery = True
        r.preemptions += 1
        # the frames are not kept: a resumed encoder-decoder request
        # restores its cross K/V from its log, as in the reference
        self.gateway.requeue_recovery([QueuedRequest(
            rid, r.prompt, r.max_new, t_enqueue=now, frames=None,
            slo_class=r.slo_class, deadline=r.deadline,
            completion_deadline=r.completion_deadline,
            completion_flagged=r.completion_flagged,
            sampling=r.sampling, session=r.session)])
        self.gateway.stats.preemptions += 1
        self.gateway.stats.bump(r.slo_class, "preempted")
        self._note_request_event(
            "preempted", rid, now,
            f"slot freed on aw{aw.aw_id}, resume@{committed + 1}")
        if self.telemetry is not None:
            self.telemetry.on_preempt(rid, now)
        return True

    def _commit_resident_kv(self, r: RequestState) -> int:
        """Bring the store's commit watermark up to the victim's whole
        resident state: a planned eviction delivers the pending WRs
        (flush; this is not a crash), and KV past the watermark (the whole
        prefix on a ``checkpoint=False`` engine, which registers the
        request now) streams out through the bulk range path. Returns the
        committed token the request resumes after."""
        ck = self.aws[r._aw].checkpointer
        if self.ecfg.checkpoint:
            ck.flush()
        else:
            ck.register(r.rid, prompt_len=len(r.prompt))
        committed = self.store.committed_token(r.rid)
        last = (r.prefill_cursor if r.prefilling else r.pos) - 1
        if committed < last:
            self._bulk_checkpoint_group([(r, committed + 1,
                                          last - committed)])
            ck.flush()
            committed = self.store.committed_token(r.rid)
        if committed != last:
            raise AssertionError(f"preempt {r.rid}: watermark {committed} "
                                 f"!= resident {last}")
        return committed

    def _deadline_pass(self, now: float, *, completion: bool):
        """One flag-once sweep for one deadline kind over the Gateway's
        queues and the resident requests. A first-token miss is excused
        when the first token landed in time (a recovery entry of a request
        that met its deadline is not a new miss), a completion miss when
        the request is done."""
        attr = "completion_flagged" if completion else "deadline_flagged"
        counter = "completion_deadline_missed" if completion \
            else "deadline_missed"
        tag = "completion, " if completion else ""

        def deadline_of(x):
            return x.completion_deadline if completion else x.deadline

        for cls, q in self.gateway.queues.items():
            for e in q:
                dl = deadline_of(e)
                if dl is None or getattr(e, attr) or now <= dl:
                    continue
                setattr(e, attr, True)
                r = self.requests.get(e.rid)
                if r is not None:
                    if getattr(r, attr):
                        continue
                    if not completion and 0 <= r.t_first_token <= dl:
                        continue
                    setattr(r, attr, True)
                self.gateway.stats.bump(cls, counter)
                self._note_request_event("deadline_missed", e.rid, now,
                                         f"{tag}queued, deadline={dl:g}")
        for r in self.requests.values():
            dl = deadline_of(r)
            if dl is None or getattr(r, attr):
                continue
            if not completion and r.t_first_token >= 0:
                # the first token itself arrived past the deadline
                if r.t_first_token <= dl:
                    continue
            elif r.done or now <= dl:
                continue
            setattr(r, attr, True)
            self.gateway.stats.bump(r.slo_class, counter)
            self._note_request_event("deadline_missed", r.rid, now,
                                     f"{tag}{r.state}, deadline={dl:g}")

    def check_deadlines(self, now: float):
        """Emit ``deadline_missed`` once per request whose first-token
        deadline passed, queued or resident without a first token, and
        once per request whose completion deadline passed before its last
        token (counted as ``completion_deadline_missed``). Deadlines are
        SLO signals: nothing is dropped."""
        self._deadline_pass(now, completion=False)
        self._deadline_pass(now, completion=True)

    # -- checkpoint streaming -------------------------------------------------
    def _bulk_checkpoint_group(self, items):
        """Stream token ranges of request slots to their AWs' store logs
        through the bulk range path (a prompt's prefix at install, a
        decode segment's tokens): ``items`` is [(request, start,
        n_tokens)]. Every range comes from one gather and one
        device-to-host copy, then goes to its AW's checkpointer as the
        reference's ``checkpoint_range`` (or, paged, ``checkpoint_blocks``)
        call. The reference groups ranges by power-of-two length to bound
        its jit keys; an eager gather takes the exact (slot, token)
        pairs."""
        items = [(r, start, n) for r, start, n in items if n > 0]
        if not items:
            return
        stacked = self.layout.extract_ranges(
            self.cache, [r.slot for r, _, _ in items],
            [start for _, start, _ in items], [n for _, _, n in items])
        at = 0
        for r, start, n in items:
            self._ck_range(self.aws[r._aw].checkpointer, r.rid, start,
                           [leaf[at:at + n] for leaf in stacked],
                           [self._ck_token_value(r, t)
                            for t in range(start, start + n)])
            at += n

    @staticmethod
    def _ck_token_value(r: RequestState, t: int) -> int:
        # the store hands back position t's *next decode input*: a prompt
        # token while t + 1 is still in the prompt, else the generated
        # token whose sampling consumed position t
        n = len(r.prompt)
        if t + 1 < n:
            return int(r.prompt[t + 1])
        k = t - n + 1
        return int(r.tokens[k]) if 0 <= k < len(r.tokens) else -1

    def _ck_range(self, ck, rid: str, start: int, seg_stack, token_values):
        """Bulk-range checkpointing, split at page boundaries on a paged
        engine (a page's worth of KV commits or dies together). The
        store's segments stay token-granular and layout-independent."""
        if self.pages is not None:
            ck.checkpoint_blocks(rid, start, seg_stack, token_values,
                                 self.pages.page_tokens)
        else:
            ck.checkpoint_range(rid, start, seg_stack, token_values)

    # -- KV facades: every clear / extend of a slot's resident KV routes
    # through here, so contiguous and paged engines share call sites. On a
    # paged engine they also run the host allocator and keep the device
    # block table in sync with its host mirror.
    def _kv_sync_bt(self):
        """Upload the host block-table mirror when it drifted."""
        if self.pages is not None and self.pages.dirty:
            self.layout.set_block_table(self.cache, self.pages.bt)
            self.pages.dirty = False

    def _kv_free_pages(self, pids):
        """Scrub freed pages' positions before they can be allocated
        again: a stale ``pos >= 0`` entry would leak the old owner's KV
        into the next owner's attention."""
        if pids:
            self.layout.scrub_pages(self.cache, pids)

    def _kv_reclaim(self, aw: int):
        """Page pressure: evict cached prefixes on ``aw`` (tail pages
        first; a page with refcount > 1 survives its holder) until a page
        frees or nothing is evictable."""
        pc = self.aws[aw].prefix_cache
        while pc is not None and self.pages.free_pages(aw) == 0:
            freed = pc.evict_pages()
            if not freed:
                break
            self._kv_free_pages(freed)

    def _kv_ensure(self, slot: int, upto: int):
        """Map pages so positions [0, upto) of ``slot`` have storage before
        a prefill, chunk or decode step writes them, reclaiming cached
        prefixes' pages under pressure. No-op on a contiguous engine (the
        slot owns its whole extent)."""
        if self.pages is None or upto <= 0:
            return
        pool = self.pages
        need = -(-min(upto, self.ecfg.max_seq) // pool.page_tokens)
        aw = pool.aw_of_slot(slot)
        for blk in range(need):
            if pool.bt[slot, blk] > 0:
                continue
            pid = pool.alloc(aw)
            if pid < 0:
                self._kv_reclaim(aw)
                pid = pool.alloc(aw)
            if pid < 0:
                raise RuntimeError(
                    f"AW{aw} out of KV pages: slot {slot} needs block "
                    f"{blk} ({need} total) and nothing is evictable")
            pool.map_block(slot, blk, pid)
        self._kv_sync_bt()

    def _kv_clear_slot(self, slot: int):
        """Release a slot's resident KV. Contiguous: reset the slot's rows.
        Paged: unmap the block-table row, return its pages to the AW's
        free list and scrub them."""
        if self.pages is None:
            self.layout.clear_slot(self.cache, slot)
            return
        self._kv_free_pages(self.pages.release_slot(slot))
        self._kv_sync_bt()

    def _kv_scrub_slot(self, slot: int, valid_len: int):
        """Mask positions >= valid_len of the slot, in place (prefix
        adoption keeps [0, valid_len))."""
        self.layout.scrub_slot(self.cache, slot, valid_len)

    def _kv_adopt(self, slot: int, pages, hit: int) -> int:
        """Map a cached entry's pages into ``slot`` (copy-on-extend): pages
        wholly below the hit are shared (refcount bumped, no KV copied),
        and the boundary page the adopter extends past the hit is copied
        into a private page on the current stream, before any later gather
        reads it. The block table is uploaded once, at the end. Returns
        the usable hit: without a free page for the boundary copy it falls
        to the last full page."""
        pool = self.pages
        pt = pool.page_tokens
        full = min(hit // pt, len(pages))
        aw = pool.aw_of_slot(slot)
        for b in range(full):
            pool.incref(pages[b])
            pool.map_block(slot, b, pages[b])
        rem = hit - full * pt
        if rem > 0 and full < len(pages):
            # pin the boundary source first: a reclaim may trim the very
            # entry being adopted, and an unpinned page could be freed and
            # scrubbed before the copy reads it
            src = int(pages[full])
            pool.incref(src)
            pid = pool.alloc(aw)
            if pid < 0:
                self._kv_reclaim(aw)
                pid = pool.alloc(aw)
            if pid < 0:
                hit = full * pt          # degrade: whole shared pages only
            else:
                self.layout.copy_page(self.cache, src, pid)
                pool.map_block(slot, full, pid)
            if pool.decref(src):
                self._kv_free_pages([src])
        elif rem > 0:
            hit = full * pt
        self._kv_sync_bt()
        return hit

    def _kv_snapshot(self, slot: int, n: int):
        """Pin the pages covering positions [0, n) of ``slot`` (one
        reference each): the backing of a new prefix-cache entry, which
        keeps them alive after the slot releases."""
        pool = self.pages
        pids = pool.slot_pages(slot, upto_blocks=-(-n // pool.page_tokens))
        for pid in pids:
            pool.incref(pid)
        return pids

    # -- failures -----------------------------------------------------------
    @property
    def failed_aws(self) -> set:
        return {w.aw_id for w in self.aws if not w.alive}

    @property
    def failed_ews(self) -> set:
        return {w.ew_id for w in self.ews if w.member and not w.alive}

    @property
    def checkpointers(self) -> dict:
        """Each AW's KV checkpointer, by AW id."""
        return {w.aw_id: w.checkpointer for w in self.aws}

    def fail_aw(self, aw: int):
        """AW crash: its slots, pages and undelivered checkpoint writes are
        gone; its requests pause until re-admitted through the Gateway.
        Requests caught mid-prefill stop their chunk stream; recovery
        resumes it from the committed cursor. Requests the store does not
        know (``checkpoint=False``) cannot be restored: as in the
        reference, they keep decoding against the dead worker's slot."""
        if self.prefix_plane is not None:
            # snapshot the dying AW's cached prefixes before fail() clears
            # them: checkpoint-backed entries become restorable orphans
            self.prefix_plane.note_aw_failed(aw)
        recoverable = set(self.store.active_requests_on(aw))
        if self.pages is not None:
            # the AW's physical pages die with it, except those of
            # unrecoverable requests (see above); freed pages are scrubbed
            # so every free page is clean when the AW is provisioned again
            keep = {r.slot for r in self.requests.values()
                    if r._aw == aw and not r.done and
                    r.rid not in recoverable}
            per = self.slots.per_aw
            freed = []
            pc = self.aws[aw].prefix_cache
            if pc is not None:
                # the entries' references go first (restoration replays
                # the orphans from the store into fresh pages)
                freed += pc.release_all_pages()
            for s in range(aw * per, (aw + 1) * per):
                if s not in keep:
                    freed += self.pages.release_slot(s)
            self._kv_free_pages(freed)
            self._kv_sync_bt()
        self.route_state = self.aws[aw].fail(self.route_state)
        if self.chunked is not None and self.ecfg.checkpoint:
            self.chunked.drop_aw(aw)
        for r in self.requests.values():
            if r._aw == aw and not r.done and r.rid in recoverable:
                r.paused = True

    def recover_aw_requests(self, now: float = 0.0) -> List[str]:
        """Per-request restoration (§6.2): requeue every request of a dead
        AW at the front of the Gateway and admit as many as capacity
        allows now; the rest stay queued and are admitted on later ticks.
        Returns the rids restored now."""
        entries = []
        for aw in sorted(self.failed_aws):
            for rid in self.store.active_requests_on(aw):
                r = self.requests.get(rid)
                if r is None or r.done or r.queued_for_recovery:
                    continue
                r.queued_for_recovery = True
                if self.telemetry is not None:
                    self.telemetry.on_failover(rid, now)
                # the recovery waiting spell starts now; class, deadline
                # and sampling survive the crash with the state
                entries.append(QueuedRequest(
                    rid, r.prompt, r.max_new, t_enqueue=now,
                    slo_class=r.slo_class, deadline=r.deadline,
                    completion_deadline=r.completion_deadline,
                    completion_flagged=r.completion_flagged,
                    sampling=r.sampling, session=r.session))
        self.gateway.requeue_recovery(entries)
        admitted = set(self.scheduler.admit(now))
        if self.prefix_plane is not None:
            # live requests took their slots first; now the dead AWs'
            # cached session prefixes move to healthy AWs
            self.prefix_plane.restore_orphans(now)
        return [q.rid for q in entries if q.rid in admitted]

    def provision_aw(self, aw: int):
        # slots still held on this AW: finished requests not yet released
        # (their release frees the slot); paused ones lost theirs
        in_use = {r.slot for r in self.requests.values()
                  if r._aw == aw and not r.paused}
        self.route_state = self.aws[aw].provision(self.route_state, in_use)

    def fail_ew(self, ew: int):
        self.route_state = self.ews[ew].fail(self.route_state)

    @property
    def live_ews(self) -> set:
        return {w.ew_id for w in self.ews if w.member and w.alive}

    def provision_ew(self, ew: int, repoint_protect: Optional[int] = None,
                     now: float = 0.0):
        """Bring EW ``ew`` back (into the pool, if it had left it); with
        ``repoint_protect``, then re-point the shadow slots to protect that
        EW (the background weight push)."""
        self.route_state = self.ews[ew].provision(self.route_state)
        if self.placement_mgr is not None and \
                ew not in self.placement_mgr.members:
            self.placement_mgr.members = sorted(
                self.placement_mgr.members + [ew])
        if repoint_protect is not None:
            self.repoint_shadows(repoint_protect, now=now)

    def repoint_shadows(self, protect_ew: int, now: float = 0.0):
        """Re-point the replica slots to protect ``protect_ew``'s experts: a
        plan generation (``plan_reprotect``, which keeps the failover
        replicas of still-dead EWs). An engine without shadow slots
        (``tarragon`` False builds no manager) has nothing to re-point.
        The expert FFN reads each slot's weights through ``slot_expert`` at
        every launch, so no weights move."""
        if self.placement_mgr is None or \
                self.api.placement.num_shadow_slots == 0:
            return
        self.install_plan(self.placement_mgr.plan_reprotect(
            protect_ew, dead_ews=tuple(self.failed_ews)), now=now)

    # -- placement plane (core/placement.py): versioned plan installs, EW
    # scale-out and scale-in, shadow promotion, load-aware rebalancing.
    # Each is a RouteState update of fixed shapes: no step graph is
    # captured anew across placement generations.
    def _plan_arrays(self, plan: PlacementPlan) -> dict:
        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                   device=self.device)
        return dict(candidates=dev(plan.candidates()),
                    slot_expert=dev(plan.slot_expert),
                    slot_owner=dev(plan.slot_owner),
                    split_slot=dev(plan.split_slot))

    def install_plan(self, plan: PlacementPlan, now: float = 0.0,
                     detail: str = ""):
        """Activate a placement generation (the orchestrator has already
        charged its weight push to the virtual clock)."""
        self.route_state = self.route_state._replace(
            **self._plan_arrays(plan))
        ev = WorkerEvent(now, "placement_changed", f"gen{plan.generation}",
                         detail or plan.reason)
        self.plan_log.append(ev)
        self.bus.publish(ev)
        if self.telemetry is not None:
            self.telemetry.registry.inc("placement.plans_installed")

    def drain_plan_events(self) -> List[WorkerEvent]:
        evs, self.plan_log = self.plan_log, []
        return evs

    @property
    def placement_generation(self) -> int:
        return self.placement_mgr.plan.generation \
            if self.placement_mgr is not None else 0

    def note_dispatch_load(self, slot_load):
        """Drain one step's per-slot dispatch counts (host array [P]) into
        the placement manager's EMAs."""
        if self.placement_mgr is not None:
            self.placement_mgr.record_slot_load(np.asarray(slot_load))

    def choose_protect_ew(self, exclude=()) -> Optional[int]:
        """The placement manager's pick of the EW whose failure would hurt
        most (the highest dispatch-load EMA; None without a manager)."""
        if self.placement_mgr is None:
            return None
        return self.placement_mgr.choose_protect_ew(tuple(exclude))

    def _require_placement(self, what: str):
        if self.placement_mgr is None:
            raise ValueError(f"{what} needs the elastic expert plane "
                             f"(MoE and tarragon)")

    def add_ew(self, now: float = 0.0) -> int:
        """Scale-out: admit a spare EW into the pool (the orchestrator has
        charged T_w + T_push); returns its id."""
        self._require_placement("add_ew")
        new_ew, plan = self.placement_mgr.plan_scale_out()
        self.route_state = self.ews[new_ew].provision(self.route_state)
        self.install_plan(plan, now=now)
        return new_ew

    def drain_ew(self, ew: int, now: float = 0.0):
        """Graceful scale-in: the EW's experts have migrated (T_push
        charged); it leaves the pool as a spare."""
        self._require_placement("drain_ew")
        self.install_plan(self.placement_mgr.plan_scale_in(ew), now=now)
        self.route_state = self.ews[ew].retire(self.route_state)

    def promote_shadows(self, dead_ew: int, now: float = 0.0):
        """Permanent shadow promotion: the dead EW's replicas become
        primaries and the pool shrinks. An ERT flip with no weight push
        (the replicas' weights are resident already)."""
        self._require_placement("promote_shadows")
        plan = self.placement_mgr.promote_shadows(dead_ew)
        self.ews[dead_ew].member = False
        self.install_plan(plan, now=now)

    def rebalance(self, now: float = 0.0) -> Optional[PlacementPlan]:
        """Load-aware re-packing of the experts over the healthy pool
        members (a failed EW awaiting revival gets no primaries)."""
        if self.placement_mgr is None:
            return None
        plan = self.placement_mgr.plan_rebalance(live=tuple(self.live_ews))
        self.install_plan(plan, now=now)
        return plan

    # -- one request to completion ------------------------------------------
    def generate(self, rid: str, prompt: np.ndarray, max_new: int
                 ) -> List[int]:
        """Run one request to completion through ``client.submit`` and
        ``step()``; returns its tokens. The request must be admitted at
        once: with no AW slot free it is refused (``RuntimeError``), as
        the reference's synchronous admission refuses it."""
        self.client.submit(RequestSpec(rid=rid, prompt=prompt,
                                       max_new=max_new))
        r = self.requests.get(rid)
        if r is None:
            self.gateway.drop(rid)
            self.client.forget(rid)
            if self.telemetry is not None:
                self.telemetry.on_drop(rid, 0.0, "refused")
            raise RuntimeError(f"request {rid!r} refused: no attention "
                               "worker has a free slot")
        while not r.done:
            self.step()
        return r.tokens

    # -- teardown -----------------------------------------------------------
    def cancel_request(self, rid: str, now: float = 0.0) -> bool:
        """Cancel a request anywhere in its lifecycle: a queued entry
        leaves its class queue; a resident request is torn down
        (``release_request``), a preempted one's recovery entry too."""
        r = self.requests.get(rid)
        if r is None:
            entry = self.gateway.drop(rid)
            if entry is None:
                return False
            self.gateway.stats.bump(entry.slo_class, "cancelled")
            self._note_request_event("cancelled", rid, now, "while queued")
            if self.telemetry is not None:
                self.telemetry.on_drop(rid, now, "cancelled")
            return True
        if r.done:
            return False
        r.cancelled = True
        r.done = True
        self.gateway.stats.bump(r.slo_class, "cancelled")
        self._note_request_event("cancelled", rid, now, r.state)
        if self.telemetry is not None:
            self.telemetry.on_cancel(rid, now, "in_flight")
        self.release_request(rid)
        return True

    def release_request(self, rid: str):
        """Full teardown of one request's footprint: the chunk stream, any
        stale recovery entry, the owning AW's slot, prefill cursor and
        pending checkpoint WRs, and the store log. Safe for done,
        cancelled and crash-paused requests alike (the slot is released
        only when this request still holds it).

        With the prefix-cache plane on, a completed request's slot is
        offered to its AW's cache: the cache adopts the slot (contiguous)
        or pins its pages (paged), with the store log under a reserved
        key."""
        r = self.requests.pop(rid, None)
        if r is None:
            return
        # deadline backstops: a first or last token that landed late in a
        # request released before the next check_deadlines still counts
        if r.deadline is not None and not r.deadline_flagged and \
                r.t_first_token > r.deadline:
            r.deadline_flagged = True
            self.gateway.stats.bump(r.slo_class, "deadline_missed")
            self._note_request_event("deadline_missed", rid,
                                     r.t_first_token,
                                     f"first token at {r.t_first_token:g} "
                                     f"> deadline {r.deadline:g}")
        if r.completion_deadline is not None and not r.completion_flagged \
                and r.t_done > r.completion_deadline:
            r.completion_flagged = True
            self.gateway.stats.bump(r.slo_class, "completion_deadline_missed")
            self._note_request_event(
                "deadline_missed", rid, r.t_done,
                f"completion at {r.t_done:g} > deadline "
                f"{r.completion_deadline:g}")
        if self.chunked is not None:
            self.chunked.drop(rid)
        if r.queued_for_recovery:
            # a stale recovery entry must not reach the scheduler
            self.gateway.drop(rid)
        cached = False
        if r._aw >= 0 and self.aws[r._aw].alive:
            aw = self.aws[r._aw]
            if not r.paused and self.prefix_plane is not None and \
                    r.done and not r.cancelled:
                # commit the resident tail, then offer the slot (its KV and
                # store log) to the AW's prefix cache
                aw.checkpointer.flush()
                cached = self.prefix_plane.offer(r)
            # pending WRs and the prefill cursor die with the request (they
            # reference a log about to be released)
            aw.drop_request(rid)
            if not r.paused and (not cached or self.pages is not None):
                # paged: the slot always releases (a cached entry pinned
                # its own page references); contiguous: a cached slot
                # belongs to its entry now and is not cleared
                if self.prefix_plane is not None and not cached:
                    # e.g. a cancelled adopter: its live entry must not
                    # survive the clear below
                    self.prefix_plane.forget_slot(r._aw, r.slot)
                self._kv_clear_slot(r.slot)
                aw.slots.release(r.slot)
        # a cached entry's log moved to its reserved key, so this releases
        # nothing of it
        self.store.release(rid)
        if self.telemetry is not None:
            self.telemetry.on_release(r)
        if self.flightrec is not None:
            self.flightrec.on_release(r)
        for hook in self._release_hooks:
            hook(r)
