"""Failover demo of the port (twin of ``examples/failover_demo.py``, paper
§7.2 at functional scale): inject an EW failure and an AW failure
mid-decode and show that the token streams are exactly the ones a
failure-free run produces: shadow-expert rerouting and per-request KV
restoration are lossless.

Requests enter through the Gateway's queue, the ContinuousBatchScheduler
prefills them in one bucketed batch, and failures are worker methods
whose blast radius is the worker's own state; the AW failure runs through
``Orchestrator.inject_failure`` and ``tick``.

    python -m repro_torch.examples.failover_demo [--device cpu]

``build()`` takes the model config (the reduced Mixtral at capacity
factor 4.0 by default), the device, optional params (e.g. converted from
the reference) and ``max_seq``; ``main()`` returns every section's
streams.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.launch.serve import require_device
from repro_torch.serving.engine import EngineConfig, InferenceEngine

PROMPTS = [np.arange(1, 9, dtype=np.int32),
           np.arange(3, 14, dtype=np.int32),
           np.arange(5, 11, dtype=np.int32)]
N_NEW = 16


def demo_config():
    cfg = get_config("mixtral_8x7b").reduced()
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))


def build(cfg=None, device="cuda", params=None, *, policy="least_loaded",
          max_seq: int = 64, seed: int = 7):
    ecfg = EngineConfig(max_batch=8, max_seq=max_seq, num_aw=2, num_ew=2,
                        placement=policy)
    return InferenceEngine(cfg if cfg is not None else demo_config(), ecfg,
                           params=params, seed=seed, device=device)


def admit_all(eng, now=0.0, log=print):
    for i, p in enumerate(PROMPTS):
        eng.gateway.enqueue(f"req-{i}", p, N_NEW, now=now)
    eng.scheduler.admit(now)
    st = eng.scheduler.stats
    log(f"  admitted {st.requests} requests in {st.calls} batched "
        f"prefill call(s), occupancy={st.occupancy():.2f}")
    for i in range(len(PROMPTS)):
        r = eng.requests[f"req-{i}"]
        log(f"    req-{i} -> AW{r.aw} slot {r.slot}")


def decode_all(eng):
    while eng.active_requests():
        eng.step()
    return {r.rid: list(r.tokens) for r in eng.requests.values()}


def main(cfg=None, device="cuda", params=None, *, max_seq: int = 64,
         log=print) -> dict:
    """Run the four sections; returns {"reference", "ew", "aw": {rid:
    tokens}, "session": {rid: AW}, "events": the AW section's
    orchestrator events as (t, kind, worker)}."""
    def make(policy="least_loaded"):
        return build(cfg, device, params, policy=policy, max_seq=max_seq)
    out = {}
    log("=== reference (no failure) ===")
    eng = make()
    admit_all(eng, log=log)
    ref = out["reference"] = decode_all(eng)
    log(f"tokens: { {k: v[:6] for k, v in sorted(ref.items())} } ...")

    log("\n=== EW failure at step 5 -> shadow-expert failover ===")
    eng = make()
    admit_all(eng, log=log)
    for _ in range(5):
        eng.step()
    log(f"killing EW0 (its experts are pre-loaded as shadows on EW1): "
        f"{eng.ews[0]}")
    eng.fail_ew(0)
    log(f"after fail: {eng.ews[0]}")
    got = out["ew"] = decode_all(eng)
    log(f"exact match: {got == ref}")

    log("\n=== AW failure at step 5 -> per-request KV restoration ===")
    eng = make()
    orch = Orchestrator(eng, worker_init_time=2.0)
    admit_all(eng, log=log)
    for _ in range(5):
        eng.step()
    victims = [r.rid for r in eng.requests.values() if r.aw == 0]
    log(f"requests {victims} live on {eng.aws[0]}; killing it")
    orch.inject_failure("aw", 0, now=1.0)
    orch.tick(1.0 + orch.detection_latency())
    for rid in victims:
        r = eng.requests[rid]
        log(f"  {rid} restored onto AW{r.aw} (slot {r.slot})")
    log(f"  {eng.store.stats.bytes_restored}B restored; "
        f"gateway requeued={eng.gateway.stats.requeued}")
    got = out["aw"] = decode_all(eng)
    log(f"exact match: {got == ref}")
    orch.tick(5.0)
    out["events"] = [(round(e.t, 2), e.kind, e.worker) for e in orch.events]
    log(f"events: {out['events']}")

    log("\n=== session-affinity placement (same session -> same AW) ===")
    eng = make("session_affinity")
    for i in range(3):
        eng.gateway.enqueue(f"sess42-{i}", PROMPTS[i], 4, now=0.0)
    eng.scheduler.admit(0.0)
    out["session"] = {r.rid: r.aw for r in eng.requests.values()}
    log(f"placements: {out['session']}")
    return out


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (cuda or cpu)")
    args = ap.parse_args(argv)
    require_device(args.device)
    main(device=args.device)


if __name__ == "__main__":
    cli()
