"""Discrete-event failover simulator (port of ``repro.core.events``;
numpy and the cost model only) — produces the paper's end-to-end
timelines (Fig. 9: TBT + output tokens/s around an injected failure) from the
calibrated cost model.

The stall behaviour is captured by the (T_w, t_pre, t_dec) cost model
(the paper's own §2.2.2 audit), calibrated from Table 1 or from an
engine's measured per-layer times. The reproduction targets are the
ratios (160-213x stall reduction, <3% overhead), which are scale-free.
``timeline_from_bus`` is not ported: it reads the telemetry bus, which
the port does not have yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from repro_torch.core import costmodel as cm


@dataclass
class SimConfig:
    num_layers: int = 32
    num_aw: int = 8
    num_ew: int = 8
    num_requests: int = 20          # concurrently decoding requests
    prompt_len: int = 10
    max_output: int = 128           # "Random" workload: 10 in / 128 out
    duration: float = 160.0         # seconds simulated
    fail_time: float = 78.0         # paper Fig. 9(a): failure at ~78 s
    sample_dt: float = 0.1
    expert_time_frac: float = 0.45  # share of a decode layer spent in EWs
    profile: cm.DeploymentProfile = field(
        default_factory=lambda: cm.MEGASCALE_PROFILE)
    tarragon: cm.TarragonProfile = field(default_factory=cm.TarragonProfile)


@dataclass
class Timeline:
    mode: str
    t: np.ndarray              # sample times
    throughput: np.ndarray     # output tokens/s
    tbt: np.ndarray            # time-between-tokens of an affected request
    stall: float               # longest token gap introduced by the failure
    events: List[str] = field(default_factory=list)


def _token_period(c: SimConfig) -> float:
    return c.num_layers * c.profile.t_dec


def _emit(c: SimConfig, period_fn, stall_windows, affected_frac=1.0
          ) -> Timeline:
    """Integrate token emission with piecewise TBT and stall windows.

    period_fn(t) -> current TBT for an affected request.
    stall_windows: list of (start, end, frac_affected) during which the
    affected fraction emits nothing.
    """
    samples = np.arange(0.0, c.duration, c.sample_dt)
    thr = np.zeros_like(samples)
    tbt = np.zeros_like(samples)
    base = c.num_requests / _token_period(c)
    for i, t in enumerate(samples):
        period = period_fn(t)
        stalled_frac = 0.0
        for (s, e, frac) in stall_windows:
            if s <= t < e:
                stalled_frac = max(stalled_frac, frac)
        active = c.num_requests * (1.0 - stalled_frac * affected_frac)
        thr[i] = active / period
        in_stall = any(s <= t < e for (s, e, _) in stall_windows)
        tbt[i] = period if not in_stall else 0.0
    # represent the affected request's max token gap
    stall = max((e - s for (s, e, f) in stall_windows if f > 0), default=0.0)
    # catch-up bump right after global stalls (queued demand drains)
    return Timeline("", samples, thr, tbt, stall)


def simulate_megascale_failure(c: SimConfig) -> Timeline:
    """Coarse-grained recovery: any worker failure -> restart + full replay
    (Fig. 3 / Fig. 9a). Stall covers ALL requests."""
    period = _token_period(c)
    # decoded tokens of the deepest in-flight request, bounded by workload
    i_fail = min(int(c.fail_time / period), c.max_output)
    layer = c.num_layers // 2
    t_model = cm.stall_decoupled_aw(c.profile, c.num_layers, layer, i_fail)
    t_stall = t_model + cm.FULL_RESTART_EXTRA  # measured-system effects
    tl = _emit(c, lambda t: period,
               [(c.fail_time, c.fail_time + t_stall, 1.0)])
    tl.mode = "megascale"
    tl.events = [f"fail@{c.fail_time:.1f}s",
                 f"Eq.1 model {t_model:.1f}s",
                 f"restart+replay {t_stall:.1f}s"]
    tl.stall = t_stall
    return tl


def simulate_tarragon_aw_failure(c: SimConfig) -> Timeline:
    """AW failure: per-request restore for the failed AW's share; the rest of
    the pipeline never pauses (Fig. 9b)."""
    period = _token_period(c)
    i_fail = min(int(c.fail_time / period), c.max_output)
    layer = c.num_layers // 2
    t_stall = cm.stall_tarragon_aw(
        c.profile, c.tarragon, c.num_layers, layer, i_fail,
        tokens_to_restore=c.prompt_len + i_fail)
    frac = 1.0 / c.num_aw
    tl = _emit(c, lambda t: period,
               [(c.fail_time, c.fail_time + t_stall, frac)])
    tl.mode = "tarragon_aw"
    tl.stall = t_stall
    tl.events = [f"fail@{c.fail_time:.1f}s",
                 f"detect+restore {t_stall * 1e3:.0f}ms",
                 f"newAW@{c.fail_time + c.profile.T_w:.1f}s"]
    return tl


def simulate_tarragon_ew_failure(c: SimConfig) -> Timeline:
    """EW failure: shadow-expert failover masks the failure (~0.3 s), reduced
    expert capacity elevates TBT until the replacement EW joins (Fig. 9c)."""
    period = _token_period(c)
    layer = c.num_layers // 2
    t_stall = cm.stall_tarragon_ew(c.profile, c.tarragon, c.num_layers,
                                   layer, 0)
    rejoin = c.fail_time + c.profile.T_w
    fe = c.expert_time_frac
    degraded = period * (1.0 + fe / max(1, c.num_ew - 1))

    def period_fn(t):
        if c.fail_time <= t < rejoin:
            return degraded
        return period

    tl = _emit(c, period_fn, [(c.fail_time, c.fail_time + t_stall, 1.0)])
    tl.mode = "tarragon_ew"
    tl.stall = t_stall
    tl.events = [f"fail@{c.fail_time:.1f}s",
                 f"shadow-failover {t_stall * 1e3:.0f}ms",
                 f"newEW@{rejoin:.1f}s"]
    return tl


def simulate_tarragon_scale_out(c: SimConfig, t_scale: float = None,
                                t_push: float = 1.0) -> Timeline:
    """EW scale-out on the versioned placement plane: the joining worker
    initializes (T_w) and receives its expert weights (T_push) entirely in
    the background; the plan installs at a layer boundary (§5.4), so there
    is NO stall window — only a TBT step-down once the expert axis widens.
    """
    period = _token_period(c)
    t_scale = c.fail_time if t_scale is None else t_scale
    join = t_scale + c.profile.T_w + t_push
    fe = c.expert_time_frac
    # expert compute spreads over one more EW after the join
    improved = period * (1.0 - fe / (c.num_ew + 1))

    def period_fn(t):
        return improved if t >= join else period

    tl = _emit(c, period_fn, [])
    tl.mode = "tarragon_scale_out"
    tl.stall = 0.0
    tl.events = [f"scale_out@{t_scale:.1f}s",
                 f"join@{join:.1f}s (T_w+T_push, zero stall)"]
    return tl


def simulate_tarragon_scale_in(c: SimConfig, t_scale: float = None,
                               t_push: float = 1.0) -> Timeline:
    """Graceful EW drain: residents migrate during T_push while the EW
    keeps serving; the shrink is again a plan install at a layer boundary —
    capacity drops, but no token gap is introduced."""
    period = _token_period(c)
    t_scale = c.fail_time if t_scale is None else t_scale
    leave = t_scale + t_push
    fe = c.expert_time_frac
    degraded = period * (1.0 + fe / max(1, c.num_ew - 1))

    def period_fn(t):
        return degraded if t >= leave else period

    tl = _emit(c, period_fn, [])
    tl.mode = "tarragon_scale_in"
    tl.stall = 0.0
    tl.events = [f"drain@{t_scale:.1f}s",
                 f"leave@{leave:.1f}s (T_push migration, zero stall)"]
    return tl


def simulate_tarragon_promotion(c: SimConfig) -> Timeline:
    """EW failure under the *promote* policy: shadows become primaries
    permanently (instant ERT flip after detection — same short stall as the
    revive policy), but the degraded-capacity window ends at re-protection
    (T_push) instead of waiting out a full worker re-init (T_w >> T_push).
    """
    period = _token_period(c)
    layer = c.num_layers // 2
    t_stall = cm.stall_tarragon_ew(c.profile, c.tarragon, c.num_layers,
                                   layer, 0)
    t_push = 1.0
    reprotect = c.fail_time + t_push
    fe = c.expert_time_frac
    degraded = period * (1.0 + fe / max(1, c.num_ew - 1))

    def period_fn(t):
        # the pool stays one EW smaller permanently: degraded TBT persists,
        # but full fault tolerance is back at t_reprotect, not t_fail + T_w
        return period if t < c.fail_time else degraded

    tl = _emit(c, period_fn, [(c.fail_time, c.fail_time + t_stall, 1.0)])
    tl.mode = "tarragon_promote"
    tl.stall = t_stall
    tl.events = [f"fail@{c.fail_time:.1f}s",
                 f"promote {t_stall * 1e3:.0f}ms",
                 f"reprotect@{reprotect:.1f}s (pool -1)"]
    return tl


def simulate_preemption_restore(c: SimConfig, t_evict: float = None,
                                wait: float = 1.0) -> Timeline:
    """Planned eviction on the recovery substrate (serving/api.py): an
    interactive burst needs the victim's slot for ``wait`` seconds. The
    victim's resident KV is already committed (the stream is flushed at
    eviction — no detection, no recompute), so its stall is the wait plus
    the per-request restore copy when it re-enters. Every other request
    keeps decoding; preemption is failure you chose, minus the failure."""
    period = _token_period(c)
    t_evict = c.fail_time if t_evict is None else t_evict
    i_evict = min(int(t_evict / period), c.max_output)
    restore = c.tarragon.restore_fixed + \
        (c.prompt_len + i_evict) * c.num_layers * \
        c.tarragon.restore_per_token
    t_stall = wait + restore + c.tarragon.resched
    frac = 1.0 / c.num_requests          # exactly one victim stalls
    tl = _emit(c, lambda t: period,
               [(t_evict, t_evict + t_stall, frac)])
    tl.mode = "preempt_restore"
    tl.stall = t_stall
    tl.events = [f"evict@{t_evict:.1f}s (watermark flushed)",
                 f"slot lent {wait:.1f}s",
                 f"restore {restore * 1e3:.0f}ms from cursor "
                 f"{c.prompt_len + i_evict} tokens"]
    return tl


def simulate_preemption_recompute(c: SimConfig, t_evict: float = None,
                                  wait: float = 1.0) -> Timeline:
    """Baseline without checkpoint-backed preemption: evicting a request
    discards its KV, so re-admission re-prefills the prompt AND replays
    every generated token (the MegaScale restart structure, scheduled
    instead of crashed)."""
    period = _token_period(c)
    t_evict = c.fail_time if t_evict is None else t_evict
    i_evict = min(int(t_evict / period), c.max_output)
    layer = c.num_layers // 2
    replay = c.num_layers * c.profile.t_pre + \
        max(0, (i_evict - 1) * c.num_layers + layer) * c.profile.t_dec
    t_stall = wait + replay + c.tarragon.resched
    frac = 1.0 / c.num_requests
    tl = _emit(c, lambda t: period,
               [(t_evict, t_evict + t_stall, frac)])
    tl.mode = "preempt_recompute"
    tl.stall = t_stall
    tl.events = [f"evict@{t_evict:.1f}s (KV discarded)",
                 f"slot lent {wait:.1f}s",
                 f"re-prefill + replay {replay:.2f}s "
                 f"({i_evict} tokens from scratch)"]
    return tl


def preemption_summary(c: SimConfig, wait: float = 1.0) -> Dict[str, float]:
    """Checkpoint-backed preemption vs discard-and-recompute: both lend
    the slot for ``wait`` seconds; the difference is what the victim pays
    on top of the loan."""
    restore = simulate_preemption_restore(c, wait=wait)
    recompute = simulate_preemption_recompute(c, wait=wait)
    return {
        "preempt_restore_stall_s": restore.stall,
        "preempt_recompute_stall_s": recompute.stall,
        "restore_overhead_s": restore.stall - wait,
        "recompute_overhead_s": recompute.stall - wait,
        "overhead_improvement_x": (recompute.stall - wait) /
                                  max(restore.stall - wait, 1e-9),
    }


def failover_summary(c: SimConfig) -> Dict[str, float]:
    base = simulate_megascale_failure(c)
    aw = simulate_tarragon_aw_failure(c)
    ew = simulate_tarragon_ew_failure(c)
    return {
        "megascale_stall_s": base.stall,
        "tarragon_aw_stall_s": aw.stall,
        "tarragon_ew_stall_s": ew.stall,
        "aw_improvement_x": base.stall / aw.stall,
        "ew_improvement_x": base.stall / ew.stall,
    }


# --------------------------------------------------------------------------
# live-engine event timeline (a consumer of the telemetry bus)
# --------------------------------------------------------------------------

def timeline_from_bus(bus, consumer: str = "events.timeline"
                      ) -> List[str]:
    """Fig. 9-style event annotations from a live engine's event bus
    (serving/telemetry.py) instead of the cost model: each call drains
    only the events past this ``consumer``'s own cursor, so the
    exporters and this timeline observe the same failure without
    stealing from each other."""
    return [f"{ev.kind}@{ev.t:.2f}s {ev.worker}"
            + (f" ({ev.detail})" if ev.detail else "")
            for ev in bus.drain(consumer)]


# --------------------------------------------------------------------------
# AW-EW link occupancy trace (paper Fig. 8) and checkpoint interleaving
# --------------------------------------------------------------------------

def link_trace(c: SimConfig, n_layers: int = 8, link_gbps: float = 400.0,
               tokens_per_dispatch: int = 64, d_model: int = 4096,
               top_k: int = 2):
    """Per-layer timeline of AW-EW link busy/idle within one decode step.

    Each layer: [attention compute (link idle)] [dispatch burst] [expert
    compute] [gather burst]. Checkpoint segments are scheduled into the
    idle attention-compute gaps (opportunistic interleaving, §6.1)."""
    t_layer = c.profile.t_dec
    fe = c.expert_time_frac
    t_attn = t_layer * (1 - fe) * 0.8
    bytes_dispatch = tokens_per_dispatch * cm.expert_traffic_bytes(
        d_model, top_k) / 2  # one direction
    t_burst = bytes_dispatch / (link_gbps / 8 * 1e9)
    seg_bytes = tokens_per_dispatch * cm.kv_segment_bytes(d_model, 32, 8)
    t_ckpt = seg_bytes / (link_gbps / 8 * 1e9)

    events = []  # (t_start, t_end, kind)
    t = 0.0
    for _ in range(n_layers):
        events.append((t, t + t_attn, "idle"))
        # checkpoint rides the idle gap
        events.append((t, t + min(t_ckpt, t_attn), "ckpt"))
        t += t_attn
        events.append((t, t + t_burst, "dispatch"))
        t += t_burst
        t_e = t_layer * fe
        events.append((t, t + t_e, "expert_idle"))
        t += t_e
        events.append((t, t + t_burst, "gather"))
        t += t_burst
    return events, {"t_burst": t_burst, "t_ckpt": t_ckpt, "t_attn": t_attn,
                    "ckpt_fits_gap": t_ckpt <= t_attn}


def checkpoint_scheme_throughput(c: SimConfig, scheme: str,
                                 interval_tokens: int = 8,
                                 kv_tokens: int = 512,
                                 d_model: int = 4096, n_heads: int = 32,
                                 n_kv_heads: int = 8,
                                 link_gbps: float = 400.0) -> float:
    """Output tokens/s under a checkpointing scheme (§7.4).

    'none'        — upper bound.
    'incremental' — Tarragon: rides idle gaps; overhead only if a segment
                    exceeds the available gap (it doesn't, App. C sizes).
    'pause'       — Pause-Checkpoint-Resume every ``interval_tokens``:
                    global stall while the WHOLE KV cache is flushed.
    """
    period = _token_period(c)
    base = c.num_requests / period
    if scheme == "none":
        return base
    seg = cm.kv_segment_bytes(d_model, n_heads, n_kv_heads) * c.num_layers
    bw = link_gbps / 8 * 1e9
    if scheme == "incremental":
        _, info = link_trace(c, d_model=d_model)
        if info["ckpt_fits_gap"]:
            return base * 0.999  # residual bookkeeping (<0.1%)
        excess = info["t_ckpt"] - info["t_attn"]
        return c.num_requests / (period + excess * c.num_layers)
    if scheme == "pause":
        # a global snapshot serializes through a barrier + host staging: no
        # pipelining with compute, no per-request overlap. Effective flush
        # bandwidth is ~1/8 of the streaming RDMA path (calibrated to the
        # paper's measured 2.15x degradation at interval=8).
        full_kv = seg * kv_tokens * c.num_requests
        t_flush = full_kv / (bw / 8) + 0.020  # + quiesce/resume latency
        eff_period = period + t_flush / interval_tokens
        return c.num_requests / eff_period
    raise ValueError(scheme)
