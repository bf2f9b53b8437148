"""``run_cell``: one run of one cell, from the seed to the result line's
dict. ``run.py`` is its command line; the tests call it on the CPU at a
tiny size."""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

from portbench import check, generator, harness, model, trace


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace_on: bool, *,
             t_start: float, device: str = "cuda",
             overrides: Optional[Dict[str, dict]] = None,
             control: bool = False,
             tamper: Optional[Callable] = None,
             bench: Optional[dict] = None,
             log: Callable[[str], None] = print) -> Tuple[dict, List[str]]:
    """Set up, measure for ``seconds``, read the metrics and check the
    served tokens. Returns (the result's dict, the compared lines).
    ``overrides`` merges into the cell, configuration and traffic files
    (``{"cell": ..., "config": ..., "traffic": ...}``); ``tamper(engine)``
    runs on the fresh engine; ``control`` puts the fp8 control in the
    program's place in the comparison."""
    import torch
    overrides = overrides or {}
    bench = bench if bench is not None else harness.load_benchmark()
    cell = _merge(harness.load_cell(cell_name), overrides.get("cell"))
    conf = _merge(model.load_config(cell["config"]), overrides.get("config"))
    mix = _merge(generator.load_mix(cell["traffic"]),
                 overrides.get("traffic"))
    entry = [w for w in bench["workloads"] if w["name"] == cell_name]
    if not entry or (entry[0]["config"], entry[0]["traffic"]) != \
            (cell["config"], cell["traffic"]):
        raise KeyError(f"cell {cell_name!r} is not BENCHMARK.json's "
                       f"(config, traffic) {entry}")
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def clock():
        return time.perf_counter() - t_start

    run = harness.Run(cell_name, cell, conf, mix, seed, seconds, trace_on)
    t0 = clock()
    cfg = model.port_config(conf)
    ecfg = model.engine_config(conf, cell)
    params = model.make_params(conf, model.bank_rows(cfg, ecfg.num_ew), seed,
                               device)
    sync()
    t_weights = clock()
    engine = model.build_engine(cfg, ecfg, params, device)
    if tamper is not None:
        tamper(engine)
    srv = harness.Serving(run, engine, clock, sync)
    traffic = generator.make_requests(mix, seed, seconds, conf["vocab_size"])
    t_engine = clock()
    warm = generator.warm_failover(mix)
    if warm is not None:
        srv.warm_failover(warm, conf["vocab_size"], seed)
    t_warm = clock()
    if "clients" in traffic:
        srv.first_wave(traffic["clients"])
    sync()
    run.t_open = clock()
    run.t_close = run.t_open + seconds
    run.setup_s = run.t_open
    log(f"set-up {run.setup_s:.3f} s: imports and card {t0:.3f}, weights "
        f"{t_weights - t0:.3f}, engine {t_engine - t_weights:.3f}, warm "
        f"failover {t_warm - t_engine:.3f}, first wave "
        f"{run.t_open - t_warm:.3f}")

    prof = cell.get("profile", {})

    def profiler():
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if cuda else [])
        return profile(activities=acts)

    fails = generator.failures(mix, seconds)
    traced = srv.window(traffic, fails, float(prof.get("at", 0.4)) *
                        seconds, int(prof.get("iterations", 100)), profiler)
    sync()
    t_end = clock()
    mem = torch.cuda.max_memory_allocated() if cuda else 0
    if traced is not None:
        # read once the window has closed: the parse takes seconds
        run.summary = trace.summarize(*traced)
    metrics = {}
    for m in harness.cell_metrics(bench, cell_name, trace_on):
        v = harness.load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    in_flight = [r for r in run.reqs.values() if r.due <= run.t_close and
                 (r.done < 0 or r.done > run.t_open)]
    steps = [s for s in run.steps if run.in_window(s.t1)]
    log(f"window {seconds} s (closed at {t_end - run.t_open:.3f}): "
        f"{len(steps)} steps, {len(run.prefill_steps())} that prefilled, "
        f"{run.window_tokens()} tokens, {len(in_flight)} requests in "
        f"flight, {sum(1 for r in in_flight if r.done > 0)} finished; "
        f"checkpoint bytes {run.ckpt_bytes}; peak device memory {mem}")
    gaps = run.gaps()
    if gaps:
        log("token gaps in the window (ms): p50 {:.3f} p95 {:.3f} p99 {:.3f} "
            "max {:.3f} over {} gaps".format(
                *(harness.percentile(gaps, q) * 1e3 for q in (50, 95, 99)),
                max(gaps) * 1e3, len(gaps)))
    if run.loop == "open":
        log(f"open loop: enqueues ran at most {run.late_s:.3f} s late")
    for f in run.failures:
        log(f"failure {f.kind}{f.worker} injected at "
            f"{f.t_inject - run.t_open:.3f} s, detected at "
            f"{f.t_detect - run.t_open:.3f} s, {len(f.victims)} victims, "
            f"tick {f.tick_s * 1e3:.3f} ms, {f.restored_bytes} bytes "
            f"restored")
    if run.summary is not None:
        s = run.summary
        log(f"traced stretch {s.window_s:.3f} s: device busy {s.busy_s:.4f} "
            f"s, {s.device_ops} device ops, by group {s.by_group}")

    # the check, once the program's state is freed
    finished = {r.rid: (r.prompt, r.tokens) for r in run.reqs.values()
                if r.done > 0 and r.tokens}
    pick = generator.rng_for(seed, 8)
    extra = {}
    for f in run.failures:
        for i in pick.permutation(len(f.victims))[
                :int(cell["check"].get("victims", 0))]:
            r = run.reqs[f.victims[i]]
            extra[r.rid] = (r.prompt, r.tokens)
    # requests the window itself admitted and prefilled, with what they
    # were served by the close: the timed prefill path and its decode
    admitted = sorted(r.rid for r in run.reqs.values()
                      if run.in_window(r.due) and r.tokens)
    for i in pick.permutation(len(admitted))[
            :int(cell["check"].get("admitted", 0))]:
        r = run.reqs[admitted[i]]
        extra[r.rid] = (r.prompt, r.tokens)
    del srv, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = check.draw_sample(finished, extra,
                               int(cell["check"]["requests"]), pick)
    t_ref = clock()
    gaps = check.served_gaps(conf, params, sample, device)
    n_tok = sum(len(g) for g in gaps)
    limit = float(cell["check"]["limit"])
    log(f"check: {len(sample)} requests ({[s[0] for s in sample]}), "
        f"{n_tok} served tokens against the float32 reference in "
        f"{clock() - t_ref:.3f} s; mean gap {check.mean(gaps)!r}, widest "
        f"{check.widest(gaps)!r}, off the reference's best "
        f"{check.share_off_best(gaps)!r}")
    if control:
        # the control in the program's place: its gaps go through the
        # same comparison, which it has to fail
        t_c = clock()
        gaps = check.control_gaps(conf, params, sample, device)
        log(f"control (fp8) in the program's place: mean gap "
            f"{check.mean(gaps)!r}, widest {check.widest(gaps)!r}, off the "
            f"reference's best {check.share_off_best(gaps)!r} in "
            f"{clock() - t_c:.3f} s")
    mean_gap = check.mean(gaps)
    result = {"correct": bool(sample) and n_tok > 0 and mean_gap <= limit,
              "attempted": len(in_flight), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda
                         else "cpu", "count": 1,
                         "memory_peak_bytes": int(mem)}}
    if trace_on and run.summary is not None:
        result["device"]["busy_s"] = run.summary.busy_s
        result["device"]["window_s"] = run.summary.window_s
        result["breakdown"] = {"device_ops": run.summary.top_ops(),
                               "idle_gaps": run.summary.top_idle()}
    compared = {"mean_logit_gap": {"value": mean_gap, "limit": limit,
                                   "rule": "<="},
                "tokens_compared": {"value": n_tok, "limit": 1,
                                    "rule": ">="}}
    result["compared"] = compared
    lines = [f"compared {k} {v['value']!r} {v['rule']} limit {v['limit']!r}"
             for k, v in compared.items()]
    del params
    gc.collect()
    return result, lines
