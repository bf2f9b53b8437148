"""Quickstart of the port (twin of ``examples/quickstart.py``): serve a
small MoE model with Tarragon resilience on.

    python -m repro_torch.examples.quickstart [--arch mixtral_8x7b] \\
        [--device cpu] [--trace quickstart_trace.json]

Builds the reduced variant of the architecture, starts the engine (2 AWs x
2 EWs), submits a few typed requests and decodes them with incremental KV
checkpointing on: ModelConfig -> InferenceEngine -> client.submit(
RequestSpec) -> RequestHandle (status, streaming, cancel) -> step. It ends
by reading the telemetry plane (on by default) and exporting a Chrome
trace of every request's lifecycle (open it at https://ui.perfetto.dev).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.serve import require_device
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine


def main(argv=None, log=print) -> dict:
    """Run the quickstart; returns {rid: tokens}, the telemetry snapshot
    under "snapshot" and the trace under "trace"."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral_8x7b")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cuda or cpu)")
    ap.add_argument("--trace", default="quickstart_trace.json",
                    help="where the Chrome trace is written")
    args = ap.parse_args(argv)
    require_device(args.device)

    cfg = get_config(args.arch).reduced()
    if cfg.moe.enabled:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    log(f"model: {cfg.name} ({cfg.param_count / 1e6:.1f}M params reduced)")

    ecfg = EngineConfig(max_batch=8, max_seq=96, num_aw=2, num_ew=2,
                        tarragon=True, checkpoint=True)
    eng = InferenceEngine(cfg, ecfg, seed=0, device=args.device)

    rng = np.random.default_rng(0)
    handles = []
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, size=(8,)).astype(np.int32)
        # classes: "interactive" preempts, "batch" is preemptible
        h = eng.client.submit(RequestSpec(
            rid=f"req{i}", prompt=prompt, max_new=args.tokens,
            slo_class="standard"))
        handles.append(h)
        log(f"{h.rid}: {h.state()} on AW{eng.requests[h.rid].aw}")

    while not all(h.done() for h in handles):
        eng.step()

    out = {}
    for h in handles:
        out[h.rid] = h.tokens()
        log(f"{h.rid}: {h.status().tokens_generated} tokens -> "
            f"{h.tokens()[:8]}...")
        eng.release_request(h.rid)   # the teardown closes the root span
    st = eng.store.stats
    log(f"checkpoint store: {st.updates} segment writes, "
        f"{st.bytes_written / 1024:.1f} KiB")

    # telemetry streams percentiles without per-request lists and traces
    # every request's lifecycle on the virtual clock
    tel = eng.telemetry
    snap = out["snapshot"] = tel.snapshot()
    qd = snap["histograms"]["queue_delay"]
    log(f"telemetry: {snap['counters'].get('requests.released', 0)} "
        f"requests released, queue delay p50={qd['p50'] * 1e3:.1f}ms "
        f"p99={qd['p99'] * 1e3:.1f}ms ({qd['count']} obs)")
    out["trace"] = tel.export_chrome(args.trace)
    log(f"wrote {args.trace} (load in ui.perfetto.dev)")
    return out


if __name__ == "__main__":
    main()
