"""Serving launcher of the port (twin of ``repro.launch.serve``): run the
Tarragon engine against a workload on the virtual clock, with failures
injected through the orchestrator.

    python -m repro_torch.launch.serve --arch mixtral_8x7b \\
        --workload random --rps 4 --duration 2 [--fail ew:0@0.5] \\
        [--scale add_ew@1.0] [--scale drain_ew:2@3.0] [--max-ew 4] \\
        [--ew-policy promote] [--rebalance] [--no-preempt] \\
        [--chunk-budget 16] [--placement session_affinity] \\
        [--prefix-slots 3] [--no-telemetry] [--trace-out T.json] \\
        [--metrics-out M.json] [--prom-out M.prom] \\
        [--controller] [--no-ctl-autoscale] [--no-ctl-rebalance] \\
        [--no-ctl-budget] [--postmortem P.json] [--watchdogs] \\
        [--no-tarragon] [--device cpu]

The reduced model (capacity factor 4.0) runs on the card unless
``--device cpu`` is given. The EW pool is elastic: scale events,
load-aware rebalancing and shadow promotion are placement-plan installs
(core/placement.py). Blocked interactive requests preempt batch victims
unless ``--no-preempt``; the prefill token cap is 8 x ``--chunk-budget``.
``--prefix-slots`` turns the prefix cache on (and chunked prefill, at a
budget of 16 when none is given); telemetry is on unless
``--no-telemetry``, and its stall attribution prints one ``[stall ...]``
line per attributed gap. ``--controller`` turns the control plane on
(EW autoscaling, trajectory-triggered weighted rebalance, the adaptive
chunk budget and, unless ``--no-preempt``, deadline-aware preemption;
``--no-ctl-*`` switch single policies off) and prints one ``[ctl ...]``
line per decision. ``--watchdogs`` turns the health watchdogs on and
prints their summary; ``--postmortem PATH`` dumps the flight recorder's
bundle at exit, which ``python -m repro_torch.launch.replay PATH`` re-runs
(add ``--device cpu`` there too for a CPU run).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.data.workloads import make_workload
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.scheduler import (FailurePlan, ScalePlan,
                                           run_serving)
from repro_torch.serving.telemetry import pct


def parse_failure(s: str) -> FailurePlan:
    kindid, t = s.split("@")
    kind, wid = kindid.split(":")
    return FailurePlan(float(t), kind, int(wid))


def parse_scale(s: str) -> ScalePlan:
    """add_ew@T | drain_ew:ID@T | rebalance@T"""
    kindid, t = s.split("@")
    kind, _, wid = kindid.partition(":")
    if kind not in ("add_ew", "drain_ew", "rebalance"):
        raise ValueError(f"unknown scale kind {kind!r} in --scale {s!r} "
                         "(add_ew@T | drain_ew:ID@T | rebalance@T)")
    return ScalePlan(float(t), kind, int(wid) if wid else -1)


def require_device(device: str):
    """No fallback: a CUDA device must exist unless the CPU was asked
    for."""
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is visible "
                           f"(pass --device cpu to run on the CPU)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral_8x7b")
    ap.add_argument("--workload",
                    choices=("random", "sharegpt", "skewed_expert_load",
                             "mixed_slo", "multi_turn_chat"),
                    default="random")
    ap.add_argument("--rps", type=float, default=4.0)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--num-aw", type=int, default=2)
    ap.add_argument("--num-ew", type=int, default=2)
    ap.add_argument("--max-ew", type=int, default=0,
                    help="elastic EW pool ceiling (spares the orchestrator "
                         "can scale out into; 0 = num_ew)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--placement", default="least_loaded",
                    choices=("least_loaded", "round_robin",
                             "session_affinity"),
                    help="Gateway AW placement policy")
    ap.add_argument("--no-tarragon", action="store_true",
                    help="MegaScale-Infer-style baseline: static expert "
                         "binding, no shadow slots, no checkpoint store")
    ap.add_argument("--fail", type=str, action="append", default=[],
                    help="kind:worker@time, e.g. ew:0@0.5")
    ap.add_argument("--scale", type=str, action="append", default=[],
                    help="add_ew@T | drain_ew:ID@T | rebalance@T")
    ap.add_argument("--ew-policy", choices=("revive", "promote"),
                    default="revive",
                    help="EW failure handling: background revival, or "
                         "permanent shadow promotion (pool shrinks)")
    ap.add_argument("--rebalance", action="store_true",
                    help="auto-rebalance expert placement under load skew")
    ap.add_argument("--controller", action="store_true",
                    help="SLO-driven closed-loop control plane: EW "
                         "autoscaling, trajectory-triggered rebalance with "
                         "weighted splits, adaptive chunk budget, and "
                         "deadline-aware preemption (serving/controller.py)")
    ap.add_argument("--no-ctl-autoscale", action="store_true",
                    help="with --controller: disable the autoscale policy")
    ap.add_argument("--no-ctl-rebalance", action="store_true",
                    help="with --controller: disable the rebalance policy")
    ap.add_argument("--no-ctl-budget", action="store_true",
                    help="with --controller: disable the adaptive "
                         "chunk budget policy")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable preempt-and-requeue (blocked interactive "
                         "requests wait instead of evicting batch victims)")
    ap.add_argument("--prefix-slots", type=int, default=0,
                    help="per-AW prefix-cache slot budget (0 = plane off; "
                         "turns chunked prefill on)")
    ap.add_argument("--chunk-budget", type=int, default=0,
                    help="chunked-prefill token budget per tick "
                         "(0 = whole-prompt prefill)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-telemetry", action="store_true",
                    help="turn the telemetry plane off (the streams are "
                         "the same either way)")
    ap.add_argument("--trace-out", default="",
                    help="write a Perfetto/Chrome trace_event JSON here")
    ap.add_argument("--postmortem", default="", metavar="PATH",
                    help="dump the flight-recorder postmortem bundle here "
                         "at exit (replay: python -m "
                         "repro_torch.launch.replay PATH)")
    ap.add_argument("--watchdogs", action="store_true",
                    help="health watchdogs: leak and stall-regression "
                         "detectors and invariant probes (prints the "
                         "health summary at exit)")
    ap.add_argument("--metrics-out", default="",
                    help="write the JSON metrics snapshot here")
    ap.add_argument("--prom-out", default="",
                    help="write the Prometheus text exposition here")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cuda or cpu)")
    args = ap.parse_args(argv)
    require_device(args.device)
    if args.prefix_slots and not args.chunk_budget:
        args.chunk_budget = 16

    cfg = get_config(args.arch).reduced()
    if cfg.moe.enabled:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    if args.workload == "multi_turn_chat" and \
            args.placement == "least_loaded":
        args.placement = "session_affinity"
    ecfg = EngineConfig(max_batch=args.max_batch, max_seq=96,
                        num_aw=args.num_aw, num_ew=args.num_ew,
                        max_ew=args.max_ew,
                        tarragon=not args.no_tarragon,
                        checkpoint=not args.no_tarragon,
                        placement=args.placement,
                        preempt=not args.no_preempt,
                        chunk_token_budget=args.chunk_budget,
                        prefill_token_cap=8 * args.chunk_budget,
                        prefix_cache_slots=args.prefix_slots,
                        telemetry=not args.no_telemetry,
                        trace_export_path=args.trace_out,
                        controller="on" if args.controller else "off",
                        ctl_autoscale=not args.no_ctl_autoscale,
                        ctl_rebalance=not args.no_ctl_rebalance,
                        ctl_chunk_budget=not args.no_ctl_budget,
                        victim_policy="controller" if args.controller and
                        not args.no_preempt else "remaining_work",
                        watchdogs=args.watchdogs)
    eng = InferenceEngine(cfg, ecfg, seed=args.seed, device=args.device)
    orch = Orchestrator(eng, worker_init_time=1.0, weight_push_time=0.25,
                        ew_policy=args.ew_policy,
                        auto_rebalance=args.rebalance)

    wl = make_workload(args.workload, args.rps, args.duration,
                       seed=args.seed, max_prompt=16, max_new=24)
    failures = [parse_failure(f) for f in args.fail]
    scales = [parse_scale(s) for s in args.scale]
    m = run_serving(eng, wl, duration=600.0, orchestrator=orch,
                    failures=failures, scale_events=scales, step_time=0.05)

    tbt = m.tbt_values()
    print(f"[serve] {cfg.name} tarragon={not args.no_tarragon} "
          f"AW={args.num_aw} EW={args.num_ew} placement={args.placement} "
          f"device={args.device}")
    print(f"  requests finished: {len(m.finished)}/{len(wl)}")
    print(f"  tokens: {len(m.token_log)}  "
          f"throughput: {m.throughput():.1f} tok/s")
    if tbt.size:
        print(f"  TBT p50={pct(tbt, 50)*1e3:.1f}ms "
              f"p95={pct(tbt, 95)*1e3:.1f}ms "
              f"max_stall={m.max_stall()*1e3:.1f}ms")
    qd = m.queue_delay_values()
    if qd.size:
        print(f"  queue delay p50={pct(qd, 50)*1e3:.1f}ms "
              f"p99={pct(qd, 99)*1e3:.1f}ms")
    if m.prefill:
        print(f"  prefill: {m.prefill['calls']} calls / "
              f"{m.prefill['requests']} reqs "
              f"occupancy={m.prefill['occupancy']:.2f}")
    if eng.placement_mgr is not None:
        mgr = eng.placement_mgr
        print(f"  expert plane: gen={mgr.plan.generation} "
              f"pool={sorted(eng.live_ews)} "
              f"imbalance={mgr.imbalance():.2f}")
    pf = m.gateway["prefix"]
    if pf["hits"] or pf["misses"]:
        print(f"  prefix cache: {pf['hits']} hits, "
              f"{pf['hit_tokens']} tokens adopted, "
              f"{pf['restored']} restored, {pf['repins']} repins")
    elif pf["repins"]:
        print(f"  session repins: {pf['repins']}")
    if m.gateway.get("by_class"):
        print(f"  request plane: preemptions={m.gateway['preemptions']}")
        for cls, counts in sorted(m.gateway["by_class"].items()):
            ttft = m.ttft_values(cls)
            extra = f" ttft_p50={pct(ttft, 50)*1e3:.0f}ms" \
                if ttft.size else ""
            print(f"    {cls}: {counts}{extra}")
    for e in orch.events:
        print(f"  [orch t={e.t:.2f}] {e.kind} {e.worker} {e.detail}")
    if eng.controller is not None:
        for d in eng.controller.decisions:
            print(f"  [ctl t={d['t']:.2f}] {d['kind']} {d['detail']}")
    if m.telemetry is not None:
        for st in m.telemetry.stall_report():
            comps = ", ".join(f"{k}={v*1e3:.0f}ms"
                              for k, v in sorted(st["components"].items())
                              if v > 1e-6)
            print(f"  [stall {st['rid']} {st['kind']} "
                  f"{st['gap']*1e3:.0f}ms] {comps}")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(m.telemetry.snapshot(), f, indent=1)
            print(f"  metrics snapshot -> {args.metrics_out}")
        if args.prom_out:
            with open(args.prom_out, "w") as f:
                f.write(m.telemetry.prometheus_text())
            print(f"  prometheus text -> {args.prom_out}")
        if args.trace_out:
            print(f"  perfetto trace -> {args.trace_out} "
                  f"(open at ui.perfetto.dev)")
    fr = eng.flightrec
    if fr is not None and fr.watchdogs is not None:
        hs = fr.watchdogs.summary()
        print(f"  health: {hs['trips']} watchdog trip(s) over "
              f"{hs['intervals']} interval(s) {dict(hs['by_kind'])}")
        for t in hs["last_trips"]:
            print(f"    [health t={t['t']:.2f}] {t['kind']} "
                  f"{t['what']}: {t['detail']}")
    if args.postmortem and fr is not None:
        fr.dump(args.postmortem, reason="postmortem on demand (--postmortem)")
        dev = "" if args.device == "cuda" else f" --device {args.device}"
        print(f"  postmortem bundle -> {args.postmortem} (replay: python -m "
              f"repro_torch.launch.replay {args.postmortem}{dev})")
    return m


if __name__ == "__main__":
    main()
