"""Deterministic incident replay from a flight-recorder postmortem bundle
(port of ``repro.launch.replay``).

``serving/flightrec.py`` captures what a serving incident was: the engine
configuration and how its weights were made, every external submission
with its prompt tokens, the fault and scale injections, the
orchestrator's timing parameters, the serving loop's clock parameters
and, with the control plane on, the controller's decision history. The
stack is deterministic on the virtual clock (counter-based sampling,
fixed step time), so that record re-runs the incident bit for bit:

  $ python -m repro_torch.launch.replay incident.postmortem.json [--device cpu]

builds a fresh engine from the bundle, injects the same faults at the
same virtual times, replays the same arrivals, and checks that every
recorded finished request comes out token for token.

Two modes:

  * ``exact`` (default): rebuild the engine as recorded, controller
    included; a controller="on" engine decides the same again because it
    sees the same signals.
  * ``script``: rebuild with the controller off and apply its recorded
    decisions as ScalePlans and a scripted chunk-budget timeline: the
    decisions, not the decider, determined the outcome.

A bundle names its weights as ``{"seed": s}`` (the engine's own seeded
draw, rebuilt here on ``device``) or null (weights the caller passed in:
the replay then needs the same ``params``). Refuses, rather than
mis-replays, bundles that are not self-contained: truncated submission or
output rings, wall-clock step time, several serving loops, failures
without an orchestrator, weights it cannot rebuild, another schema (a
bundle of the JAX package names JAX weights the port cannot rebuild).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
from repro_torch.core.costmodel import TarragonProfile
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.launch.serve import require_device
from repro_torch.serving import flightrec
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.scheduler import FailurePlan, ScalePlan, run_serving


class BundleError(ValueError):
    """The bundle cannot be replayed faithfully; the message says why."""


def _check_schema(bundle: dict):
    if bundle.get("schema") != flightrec.SCHEMA:
        raise BundleError(
            f"unsupported bundle schema {bundle.get('schema')!r} "
            f"(this tool reads {flightrec.SCHEMA})")


def load_bundle(path: str) -> dict:
    with open(path) as f:
        bundle = json.load(f)
    _check_schema(bundle)
    return bundle


@dataclasses.dataclass(frozen=True)
class ReplayRequest:
    """A recorded submission, shaped like ``data.workloads.Request`` for
    ``run_serving``, carrying the captured prompt verbatim."""
    request_id: str
    arrival: float
    max_new_tokens: int
    prompt: np.ndarray
    slo_class: str = "standard"
    deadline: float = -1.0
    session: str = ""

    def prompt_tokens(self, vocab: int) -> np.ndarray:
        return self.prompt


def _filter_fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def rebuild_model_config(d: dict) -> ModelConfig:
    d = dict(d)
    moe = MoEConfig(**_filter_fields(MoEConfig, d.pop("moe", {}) or {}))
    ssm = SSMConfig(**_filter_fields(SSMConfig, d.pop("ssm", {}) or {}))
    kw = _filter_fields(ModelConfig, d)
    for k, v in kw.items():     # JSON round-trips tuples as lists
        if isinstance(v, list):
            kw[k] = tuple(v)
    return ModelConfig(moe=moe, ssm=ssm, **kw)


def rebuild_engine_config(d: dict, mode: str) -> EngineConfig:
    kw = _filter_fields(EngineConfig, dict(d))
    # a replay must not overwrite the incident's own bundle or trace (both
    # knobs are left out of the config hash, so the handshake holds)
    kw["flight_autodump"] = ""
    kw["trace_export_path"] = ""
    if mode == "script":
        if kw.get("victim_policy") == "controller":
            raise BundleError(
                'script-mode replay cannot run victim_policy="controller" '
                "(preemption victims are chosen inside the controller, "
                "not recorded as decisions) — use --mode exact")
        kw["controller"] = "off"
    return EngineConfig(**kw)


def _rebuild_requests(bundle: dict) -> List[ReplayRequest]:
    reqs = []
    for s in bundle["submissions"]:
        if s.get("sampling") is not None or \
                s.get("completion_deadline") is not None:
            raise BundleError(
                f"submission {s['rid']!r} carries client-API fields "
                "(sampling/completion_deadline) the serving-loop replay "
                "cannot inject")
        reqs.append(ReplayRequest(
            request_id=s["rid"], arrival=float(s["t"]),
            max_new_tokens=int(s["max_new"]),
            prompt=np.asarray(s["prompt"], np.int32),
            slo_class=s.get("slo_class") or "standard",
            deadline=-1.0 if s.get("deadline") is None
            else float(s["deadline"]),
            session=s.get("session") or ""))
    return sorted(reqs, key=lambda r: (r.arrival, r.request_id))


def _validate(bundle: dict):
    _check_schema(bundle)
    tr = bundle.get("truncated", {})
    if tr.get("submissions") or tr.get("outputs"):
        raise BundleError(
            f"bundle rings truncated (submissions dropped="
            f"{tr.get('submissions')}, outputs dropped="
            f"{tr.get('outputs')}): the workload is incomplete — raise "
            "flight_capacity on the recording engine")
    loops = bundle.get("loops", [])
    if len(loops) != 1:
        raise BundleError(
            f"bundle records {len(loops)} serving loops; replay needs "
            "exactly one (multi-run engines are not replayable as a unit)")
    loop = loops[0]
    if loop["step_time"] is None:
        raise BundleError(
            "recorded loop ran on wall-clock step time; only virtual-clock "
            "runs (step_time=...) replay deterministically")
    if bundle["injections"]["failures"] and bundle.get("orchestrator") \
            is None:
        raise BundleError(
            "bundle records failure injections but no orchestrator "
            "parameters — cannot reconstruct detection/recovery timing")


def _build_engine(bundle: dict, cfg: ModelConfig, ecfg: EngineConfig,
                  params, device) -> InferenceEngine:
    if params is not None:
        return InferenceEngine(cfg, ecfg, params=params, device=device)
    weights = bundle["config"].get("weights")
    if not weights or "seed" not in weights:
        raise BundleError(
            "bundle records weights the caller passed in (weights: null); "
            "replay needs the same params (replay_bundle(..., params=...))")
    return InferenceEngine(cfg, ecfg, seed=int(weights["seed"]),
                           device=device)


def replay_bundle(bundle: dict, mode: str = "exact", *, params=None,
                  device="cuda") -> dict:
    """Re-run the recorded incident on ``device``; return a comparison
    report. ``report["ok"]`` is True iff every recorded finished request
    comes out token for token (and none goes missing)."""
    if mode not in ("exact", "script"):
        raise ValueError(f"unknown replay mode {mode!r} (exact | script)")
    _validate(bundle)
    cfg = rebuild_model_config(bundle["config"]["model"])
    ecfg = rebuild_engine_config(bundle["config"]["engine"], mode)
    eng = _build_engine(bundle, cfg, ecfg, params, device)

    hash_ok = True
    if mode == "exact" and eng.flightrec is not None:
        hash_ok = eng.flightrec.config_hash == bundle["config"]["hash"]

    orch: Optional[Orchestrator] = None
    od = bundle.get("orchestrator")
    if od is not None:
        profile = dataclasses.replace(
            TarragonProfile(), detect=od["profile_detect"],
            detect_retries=od["profile_detect_retries"])
        orch = Orchestrator(eng, profile=profile,
                            worker_init_time=od["worker_init_time"],
                            weight_push_time=od["weight_push_time"],
                            ew_policy=od["ew_policy"],
                            auto_rebalance=od["auto_rebalance"],
                            rebalance_cooldown=od["rebalance_cooldown"])

    failures = [FailurePlan(f["t"], f["kind"], f["worker_id"])
                for f in bundle["injections"]["failures"]]
    scales = [ScalePlan(s["t"], s["kind"], s["worker_id"])
              for s in bundle["injections"]["scales"]]

    if mode == "script" and bundle.get("controller"):
        # the recorded decisions become ScalePlans and a scripted budget
        # timeline on a controller-off engine
        decisions = bundle["controller"]["decisions"]
        kind_map = {"scale_out": "add_ew", "scale_in": "drain_ew",
                    "rebalance": "rebalance"}
        scales = scales + [
            ScalePlan(d["t"], kind_map[d["kind"]], d.get("ew", -1))
            for d in decisions if d["kind"] in kind_map]
        if eng.placement_mgr is not None:
            # the controller switches the replica packer to weighted splits
            # at construction; the scripted twin must plan the same
            eng.placement_mgr.split_mode = "weighted"
        budget_script = sorted((d["t"], d["budget"]) for d in decisions
                               if d["kind"] == "budget")
        orig_step = eng.step

        def scripted_step(now=None):
            while budget_script and now is not None and \
                    now >= budget_script[0][0]:
                eng.chunked.set_budget(budget_script.pop(0)[1])
            return orig_step(now=now)
        eng.step = scripted_step

    loop = bundle["loops"][0]
    workload = _rebuild_requests(bundle)
    m = run_serving(eng, workload, loop["duration"], orchestrator=orch,
                    failures=failures, scale_events=scales,
                    step_time=loop["step_time"],
                    prefill_token_time=loop["prefill_token_time"],
                    max_steps=loop["max_steps"])

    recorded = bundle["outputs"]
    mismatched, missing = [], []
    for rid, toks in sorted(recorded.items()):
        got = m.outputs.get(rid)
        if got is None:
            missing.append(rid)
        elif list(got) != list(toks):
            mismatched.append(rid)
    extra = sorted(set(m.outputs) - set(recorded))
    report = {
        "mode": mode,
        "reason": bundle.get("reason"),
        "config_hash": bundle["config"]["hash"],
        "config_hash_ok": hash_ok,
        "requests_recorded": len(recorded),
        "requests_replayed": len(m.outputs),
        "matched": len(recorded) - len(mismatched) - len(missing),
        "mismatched": mismatched,
        "missing": missing,
        "extra_finished": extra,
        "failures_injected": len(failures),
        "scale_events": len(scales),
        "ok": hash_ok and not mismatched and not missing,
    }
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Deterministically replay a flight-recorder "
                    "postmortem bundle and verify bit-identical outputs")
    p.add_argument("bundle", help=f"path to a {flightrec.SCHEMA} JSON")
    p.add_argument("--mode", choices=("exact", "script"), default="exact",
                   help="exact: rebuild the engine as recorded; script: "
                        "controller off, decisions replayed as a script")
    p.add_argument("--device", default="cuda",
                   help="torch device of the replayed engine (cuda, or cpu "
                        "for the plain PyTorch path)")
    p.add_argument("--out", default="",
                   help="write the comparison report JSON here")
    args = p.parse_args(argv)
    require_device(args.device)

    try:
        bundle = load_bundle(args.bundle)
        report = replay_bundle(bundle, mode=args.mode, device=args.device)
    except BundleError as e:
        print(f"replay refused: {e}", file=sys.stderr)
        return 2
    print(f"replay[{report['mode']}] of {args.bundle} "
          f"(dumped: {report['reason']!r})")
    print(f"  config hash {report['config_hash']} "
          f"{'ok' if report['config_hash_ok'] else 'MISMATCH'}")
    print(f"  recorded finished: {report['requests_recorded']}  "
          f"replayed finished: {report['requests_replayed']}")
    print(f"  matched: {report['matched']}  "
          f"mismatched: {len(report['mismatched'])}  "
          f"missing: {len(report['missing'])}")
    if report["mismatched"]:
        print(f"  token-mismatched rids: {report['mismatched'][:10]}")
    if report["missing"]:
        print(f"  missing rids: {report['missing'][:10]}")
    verdict = "BIT-IDENTICAL" if report["ok"] else "DIVERGED"
    print(f"  verdict: {verdict}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
