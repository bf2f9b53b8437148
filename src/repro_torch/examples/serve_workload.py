"""End-to-end serving example of the port (twin of
``examples/serve_workload.py``): a Poisson request stream against the
engine, with an orchestrator handling a mid-run worker failure, on the
virtual clock. Reports TTFT, TBT and throughput around the failure.

    python -m repro_torch.examples.serve_workload --workload random \\
        --rps 4 --fail-at 0.5 [--controller] [--watchdogs] \\
        [--postmortem P.json] [--device cpu]

The reduced Mixtral (capacity factor 4.0) runs on the card unless
``--device cpu`` is given, with the reference's engine settings and
prints. ``--controller`` turns the control plane on (it needs the chunked
plane, so the budget becomes 16 when none is given, and it may grow the EW
pool to 4); ``--postmortem`` writes the flight recorder's bundle, which
``python -m repro_torch.launch.replay P.json`` re-runs.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.data.workloads import make_workload
from repro_torch.launch.serve import require_device
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.scheduler import FailurePlan, run_serving
from repro_torch.serving.telemetry import pct


def main(argv=None, log=print):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload",
                    choices=("random", "sharegpt", "long_prompt_burst",
                             "skewed_expert_load", "mixed_slo",
                             "multi_turn_chat"),
                    default="random")
    ap.add_argument("--rps", type=float, default=4.0)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--fail-at", type=float, default=0.5)
    ap.add_argument("--fail-kind", choices=("ew", "aw", "none"),
                    default="ew")
    ap.add_argument("--chunk-budget", type=int, default=0,
                    help="chunked-prefill token budget per tick "
                         "(0 = whole-prompt prefill)")
    ap.add_argument("--rebalance", action="store_true",
                    help="let the orchestrator rebalance expert placement "
                         "when dispatch load is imbalanced (pairs with "
                         "--workload skewed_expert_load)")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable preempt-and-requeue (pairs with "
                         "--workload mixed_slo: blocked interactive "
                         "requests then wait out the batch wave)")
    ap.add_argument("--controller", action="store_true",
                    help="SLO-driven closed-loop control plane: the "
                         "engine autoscales the EW pool, triggers "
                         "weighted rebalances off the load trajectory, "
                         "adapts the chunk budget to deadline headroom, "
                         "and gates preemption on deadline risk")
    ap.add_argument("--prefix-slots", type=int, default=0,
                    help="per-AW prefix-cache slot budget (pairs with "
                         "--workload multi_turn_chat; needs a chunk "
                         "budget; 0 = plane off)")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable the telemetry plane (metrics registry, "
                         "span tracing, stall attribution); the streams "
                         "are the same either way")
    ap.add_argument("--trace-out", default="",
                    help="write a Perfetto/Chrome trace_event JSON of "
                         "the run here (open at ui.perfetto.dev)")
    ap.add_argument("--postmortem", default="", metavar="PATH",
                    help="dump the flight-recorder postmortem bundle "
                         "here at exit (replay: python -m "
                         "repro_torch.launch.replay PATH)")
    ap.add_argument("--watchdogs", action="store_true",
                    help="health watchdogs (leak / stall regression / "
                         "invariant probes); prints the health summary "
                         "at exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cuda or cpu)")
    args = ap.parse_args(argv)
    require_device(args.device)
    if args.prefix_slots and not args.chunk_budget:
        args.chunk_budget = 16     # the prefix plane rides chunked prefill

    cfg = get_config("mixtral_8x7b").reduced()
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    placement = "session_affinity" if args.workload == "multi_turn_chat" \
        else "least_loaded"
    if args.controller and not args.chunk_budget:
        args.chunk_budget = 16     # the budget policy needs the plane on
    ecfg = EngineConfig(max_batch=8, max_seq=96, num_aw=2, num_ew=2,
                        max_ew=4 if args.controller else 0,
                        chunk_token_budget=args.chunk_budget,
                        prefill_token_cap=8 * args.chunk_budget,
                        preempt=not args.no_preempt,
                        placement=placement,
                        prefix_cache_slots=args.prefix_slots,
                        telemetry=not args.no_telemetry,
                        trace_export_path=args.trace_out,
                        controller="on" if args.controller else "off",
                        victim_policy="controller" if args.controller and
                        not args.no_preempt else "remaining_work",
                        watchdogs=args.watchdogs)
    eng = InferenceEngine(cfg, ecfg, seed=0, device=args.device)
    orch = Orchestrator(eng, worker_init_time=1.0, weight_push_time=0.25,
                        auto_rebalance=args.rebalance)

    max_prompt = 64 if args.workload == "long_prompt_burst" else 16
    wl = make_workload(args.workload, args.rps, args.duration, seed=1,
                       max_prompt=max_prompt, max_new=24)
    wl = [dataclasses.replace(w, prompt_len=min(w.prompt_len, max_prompt),
                              max_new_tokens=min(w.max_new_tokens, 24))
          for w in wl]
    failures = [] if args.fail_kind == "none" else \
        [FailurePlan(args.fail_at, args.fail_kind, 0)]

    m = run_serving(eng, wl, duration=600.0, orchestrator=orch,
                    failures=failures, step_time=0.05,
                    prefill_token_time=0.002)

    tbt = m.tbt_values()
    log(f"requests: {len(wl)} submitted, {len(m.finished)} finished")
    log(f"tokens:   {len(m.token_log)}  "
        f"throughput: {m.throughput():.1f} tok/s (virtual)")
    if tbt.size:
        log(f"TBT: median={pct(tbt, 50)*1e3:.1f}ms "
            f"p95={pct(tbt, 95)*1e3:.1f}ms "
            f"max_stall={m.max_stall()*1e3:.1f}ms")
    if m.ttft:
        t = list(m.ttft.values())
        log(f"TTFT (virtual, from arrival): median={pct(t, 50)*1e3:.1f}ms")
    qd = m.queue_delay_values()
    if qd.size:
        log(f"queue delay: p50={pct(qd, 50)*1e3:.1f}ms "
            f"p99={pct(qd, 99)*1e3:.1f}ms "
            f"blocked_ticks={eng.gateway.stats.blocked_ticks}")
    if m.prefill:
        log(f"prefill: {m.prefill['calls']} batched calls for "
            f"{m.prefill['requests']} requests "
            f"(occupancy={m.prefill['occupancy']:.2f})")
        ch = m.prefill.get("chunked")
        if ch:
            log(f"chunked prefill: {ch['chunks']} chunks in "
                f"{ch['calls']} calls for {ch['requests']} streams "
                f"(shapes={ch['shapes']}, resumed={ch['resumed']})")
    pf = m.gateway.get("prefix", {})
    if pf.get("hits") or pf.get("misses"):
        log(f"prefix cache: {pf['hits']} hits / "
            f"{pf['hits'] + pf['misses']} lookups, "
            f"{pf['hit_tokens']} prompt tokens adopted, "
            f"{pf['evictions']} evictions, {pf['restored']} restored, "
            f"{pf['repins']} session repins")
    if m.gateway.get("by_class"):
        log(f"request plane: preemptions={m.gateway['preemptions']}")
        for cls, counts in sorted(m.gateway["by_class"].items()):
            ttft = m.ttft_values(cls)
            extra = f" ttft_p50={pct(ttft, 50)*1e3:.0f}ms " \
                    f"p99={pct(ttft, 99)*1e3:.0f}ms" \
                if ttft.size else ""
            log(f"  {cls}: {counts}{extra}")
    if eng.placement_mgr is not None:
        mgr = eng.placement_mgr
        loads = {k: round(v, 1) for k, v in mgr.per_ew_load().items()}
        log(f"expert plane: gen={mgr.plan.generation} "
            f"imbalance(max/mean)={mgr.imbalance():.2f} "
            f"per-EW load={loads}")
    for e in orch.events:
        log(f"  [orch t={e.t:.2f}s] {e.kind} {e.worker} {e.detail}")
    if eng.controller is not None:
        log(f"control plane: decisions={eng.controller.counts}")
        for d in eng.controller.decisions:
            log(f"  [ctl t={d['t']:.2f}s] {d['kind']} {d['detail']}")
    if m.telemetry is not None:
        for st in m.telemetry.stall_report():
            comps = ", ".join(f"{k}={v*1e3:.0f}ms"
                              for k, v in sorted(st["components"].items())
                              if v > 1e-6)
            log(f"  [stall {st['rid']} {st['kind']} "
                f"{st['gap']*1e3:.0f}ms] {comps}")
        if args.trace_out:
            log(f"trace written to {args.trace_out} "
                f"(open at ui.perfetto.dev)")
    fr = eng.flightrec
    if fr is not None and fr.watchdogs is not None:
        hs = fr.watchdogs.summary()
        log(f"health: {hs['trips']} watchdog trip(s) over "
            f"{hs['intervals']} interval(s) {dict(hs['by_kind'])}")
        for t in hs["last_trips"]:
            log(f"  [health t={t['t']:.2f}s] {t['kind']} "
                f"{t['what']}: {t['detail']}")
    if args.postmortem and fr is not None:
        fr.dump(args.postmortem,
                reason="postmortem on demand (--postmortem)")
        dev = "" if args.device == "cuda" else f" --device {args.device}"
        log(f"postmortem bundle written to {args.postmortem} "
            f"(replay: python -m repro_torch.launch.replay "
            f"{args.postmortem}{dev})")
    return m


if __name__ == "__main__":
    main()
