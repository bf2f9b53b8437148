"""The port's serving loop against the JAX package's: ``run_serving`` on
the launcher's engine (reduced Mixtral at capacity factor 4.0, 2 AWs x 2
EWs, max_seq 96) with ``step_time=0.05`` over one ShareGPT-like Poisson
workload, with no failure, with ``ew:0@0.3`` and with ``aw:0@0.3``:
outputs, finished order, TTFTs, queueing delays and orchestrator events
equal the reference's. The engine options the launcher sets
(``checkpoint``, ``placement``, the ``tarragon=False, checkpoint=False``
baseline under an AW failure, ``session_affinity`` re-pinning off a failed
AW) against the reference with the same option; ``ServeMetrics`` and
``parse_failure`` against the reference's; the launcher twin on the CPU;
and the failover demo twin's sections against the JAX demo's
(``examples/failover_demo.py``, loaded as it is). Both engines keep a
placement manager, and their ``placement_changed`` events are compared
with the rest; ``scale_events`` (a scale-out, a rebalance and a drain)
run on both packages too."""
import contextlib
import dataclasses
import importlib.util
import io
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import reduced
from repro.core.orchestrator import Orchestrator as JOrch
from repro.launch import serve as jserve
from repro.serving import prefixcache as jprefixcache
from repro.data.workloads import make_workload as jmake_workload
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.scheduler import FailurePlan as JFailurePlan
from repro.serving.scheduler import ScalePlan as JScalePlan
from repro.serving.scheduler import ServeMetrics as JServeMetrics
from repro.serving.scheduler import TokenRecord as JTokenRecord
from repro.serving.scheduler import run_serving as jrun_serving
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core.orchestrator import Orchestrator as TOrch
from repro_torch.data.workloads import make_workload
from repro_torch.examples import failover_demo as tdemo
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.scheduler import (FailurePlan, ScalePlan,
                                           ServeMetrics, TokenRecord,
                                           run_serving)

BASE = dict(max_batch=8, max_seq=96, num_aw=2, num_ew=2)
# 13 requests of up to 40 prompt tokens and 16 new ones; four arrive at
# once, so AW0 holds two decoding requests at t = 0.3
WORKLOAD = dict(kind="sharegpt", rate_rps=12.0, duration=1.0, seed=0,
                max_prompt=40, max_new=16)
FAILURES = {"none": [], "ew": [(0.3, "ew", 0)], "aw": [(0.3, "aw", 0)],
            "aw1": [(0.3, "aw", 1)]}
# the orchestrator's T_w 1.0 and T_push 0.25: EW2 joins at 1.35
SCALES = [(0.1, "add_ew"), (1.4, "rebalance"), (1.7, "drain_ew", 2)]


def _port_cfg():
    cfg = tget_config("mixtral_8x7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))


def _jax_engine(**kw):
    return JEngine(
        reduced("mixtral_8x7b", cap_factor=4.0),
        JEngineConfig(**BASE, telemetry=False, flight_recorder=False, **kw),
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def served():
    """serve(pkg, failures, **engine options) -> the run's comparable
    record, memoised across the module's tests."""
    params, memo = {}, {}

    def serve(pkg, failures="none", scales=(), **kw):
        key = (pkg, failures, scales, tuple(sorted(kw.items())))
        if key in memo:
            return memo[key]
        fails = FAILURES[failures]
        if pkg == "jax":
            eng = _jax_engine(**kw)
            params.setdefault("port", params_from_reference(eng.params,
                                                            device="cpu"))
            orch = JOrch(eng, worker_init_time=1.0, weight_push_time=0.25)
            m = jrun_serving(eng, jmake_workload(**WORKLOAD), 600.0,
                             orchestrator=orch, step_time=0.05,
                             failures=[JFailurePlan(*f) for f in fails],
                             scale_events=[JScalePlan(*s) for s in scales])
        else:
            if "port" not in params:
                serve("jax")
            eng = InferenceEngine(_port_cfg(), EngineConfig(**BASE, **kw),
                                  params=params["port"], device="cpu")
            orch = TOrch(eng, worker_init_time=1.0, weight_push_time=0.25)
            m = run_serving(eng, make_workload(**WORKLOAD), 600.0,
                            orchestrator=orch, step_time=0.05,
                            failures=[FailurePlan(*f) for f in fails],
                            scale_events=[ScalePlan(*s) for s in scales])
        events = [(e.t, e.kind, e.worker, e.detail) for e in orch.events]
        memo[key] = rec = dict(
            outputs=m.outputs, finished=m.finished, ttft=m.ttft,
            queue_delay=m.queue_delay, events=events, prefill=m.prefill,
            tokens=len(m.token_log),
            bytes_written=eng.store.stats.bytes_written,
            restores=eng.store.stats.restores, gateway=m.gateway,
            generation=eng.placement_generation)
        return rec
    return serve


def same(got, want):
    for k in ("outputs", "finished", "ttft", "queue_delay", "events",
              "prefill", "tokens", "restores", "generation"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("failures", ["none", "ew", "aw"])
def test_run_serving_matches_reference(served, failures):
    got, want = served("port", failures), served("jax", failures)
    same(got, want)
    n = len(make_workload(**WORKLOAD))
    assert len(got["finished"]) == n
    # failover is lossless: every stream equals the failure-free run's
    assert got["outputs"] == served("port")["outputs"]
    kinds = [e[1] for e in got["events"]]
    if failures == "none":
        assert kinds == []
    elif failures == "ew":
        # the revived EW's shadows re-point to the most loaded EW: a plan
        assert kinds == ["fail_ew", "detected", "provisioned",
                         "placement_changed"]
    else:
        assert kinds == [f"fail_{failures}", "detected", "provisioned"]
    if failures == "aw":
        assert got["events"][1][3] == "restored 2 requests"
        assert got["restores"] == 2


@pytest.mark.parametrize("option", [{"checkpoint": False}],
                         ids=["checkpoint_off"])
def test_engine_options_match_reference(served, option):
    got, want = served("port", **option), served("jax", **option)
    same(got, want)
    # the streams of the default engine: no store changes no token
    assert got["outputs"] == served("port")["outputs"]
    if option.get("checkpoint") is False:
        assert got["bytes_written"] == 0
    else:
        assert got["bytes_written"] > 0


def test_baseline_aw_failure_restores_nothing(served):
    """``tarragon=False, checkpoint=False`` under an AW failure: the store
    knows no request, so nothing is paused or restored and the dead AW's
    requests keep decoding against its slots, as in the reference."""
    opt = dict(tarragon=False, checkpoint=False)
    got, want = served("port", "aw", **opt), served("jax", "aw", **opt)
    same(got, want)
    assert got["events"][1][3] == "restored 0 requests"
    assert got["restores"] == 0 and got["bytes_written"] == 0
    assert len(got["finished"]) == len(make_workload(**WORKLOAD))


def test_session_affinity_repins_through_the_orchestrator(served):
    """Every request of the workload shares the session key "sharegpt",
    whose home is AW1: failing AW1 re-pins the session, and the
    ``session_repinned`` event reaches the orchestrator's log through the
    engine's ``drain_request_events``, as in the reference."""
    opt = dict(placement="session_affinity")
    got, want = served("port", "aw1", **opt), served("jax", "aw1", **opt)
    same(got, want)
    assert [e[1] for e in got["events"]].count("session_repinned") == 1
    assert got["outputs"] == served("port")["outputs"]


def test_scale_events_name_the_placement_plane(served):
    """``run_serving(scale_events=...)``: a scale-out to max_ew 3, a
    rebalance and a drain of the joined EW, on both packages, with equal
    outputs, TTFTs, events and plan generations; the replicas serve the
    same weights, so every stream is the failure-free run's."""
    scales = tuple(SCALES)
    got = served("port", scales=scales, max_ew=3)
    want = served("jax", scales=scales, max_ew=3)
    same(got, want)
    assert got["outputs"] == served("port")["outputs"]
    assert got["generation"] == 3
    assert [e[1] for e in got["events"]] == [
        "scale_out_started", "scaled_out", "placement_changed",
        "rebalance_started", "rebalanced", "placement_changed",
        "drain_started", "scaled_in", "placement_changed"]
    eng = InferenceEngine(_port_cfg(), EngineConfig(**BASE), device="cpu")
    with pytest.raises(ValueError, match="orchestrator"):
        run_serving(eng, [], 1.0, scale_events=[ScalePlan(0.0, "add_ew")])
    with pytest.raises(ValueError, match="scale event kind"):
        run_serving(eng, [], 1.0, orchestrator=TOrch(eng),
                    scale_events=[ScalePlan(0.0, "grow")])


@pytest.mark.parametrize("slo_class", [None, "interactive", "batch"])
def test_serve_metrics_match_reference(slo_class):
    """Every ServeMetrics method against the reference's on one seeded
    record (and on an empty one), per SLO class."""
    rng = np.random.default_rng(3)
    rids = [f"r{i}" for i in range(6)]
    log = sorted((float(t), str(rng.choice(rids)))
                 for t in rng.uniform(0.0, 3.0, 60))
    rec = dict(ttft={r: float(rng.uniform(0.01, 0.5)) for r in rids},
               queue_delay={r: float(rng.uniform(0.0, 0.2)) for r in rids},
               slo_class={r: ("interactive", "batch")[i % 2]
                          for i, r in enumerate(rids)},
               duration=3.1)
    pairs = [(ServeMetrics(token_log=[TokenRecord(t, r) for t, r in log],
                           **rec),
              JServeMetrics(token_log=[JTokenRecord(t, r) for t, r in log],
                            **rec)),
             (ServeMetrics(), JServeMetrics())]
    for got, want in pairs:
        assert got.throughput() == want.throughput()
        assert got.max_stall(slo_class) == want.max_stall(slo_class)
        for name in ("tbt_values", "ttft_values"):
            np.testing.assert_array_equal(getattr(got, name)(slo_class),
                                          getattr(want, name)(slo_class))
        np.testing.assert_array_equal(got.queue_delay_values(),
                                      want.queue_delay_values())
        for dt in (0.25, 0.5):
            for a, b in zip(got.throughput_timeline(dt),
                            want.throughput_timeline(dt)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", ["aw:0@0.5", "ew:1@2", "ew:3@1e-1",
                                  "aw0@0.5", "aw:x@1", "aw:0"])
def test_parse_failure_matches_reference(spec):
    """The launcher twin's ``--fail`` parser: the reference's plan for a
    well-formed spec, the reference's error for a malformed one."""
    try:
        want = dataclasses.astuple(jserve.parse_failure(spec))
    except ValueError as e:
        with pytest.raises(type(e)):
            tserve.parse_failure(spec)
    else:
        assert dataclasses.astuple(tserve.parse_failure(spec)) == want


def test_launcher_twin_on_cpu():
    assert tserve.parse_failure("ew:1@0.75") == FailurePlan(0.75, "ew", 1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        m = tserve.main(["--device", "cpu", "--workload", "sharegpt",
                         "--rps", "8", "--duration", "0.5",
                         "--fail", "aw:0@0.1", "--placement",
                         "session_affinity"])
    text = out.getvalue()
    n = len(make_workload("sharegpt", 8.0, 0.5, seed=0, max_prompt=16,
                          max_new=24))
    assert len(m.finished) == n > 0
    assert f"requests finished: {n}/{n}" in text
    assert "detected aw0 restored" in text and "provisioned aw0" in text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tserve.main(["--duration", "0.1"])


def test_launcher_prefix_cache_matches_reference(monkeypatch):
    """``--workload multi_turn_chat --prefix-slots 3`` through both
    launchers, with AW1 (the home of a cached session) failing: the same
    prefix-cache line (hits, adopted tokens, restored prefixes, re-pins),
    orchestrator events (``prefix_restored``, ``session_repinned``) and
    stall lines. Every request ends at max_new, so these lines do not
    depend on the two launchers' weights."""
    args = ["--workload", "multi_turn_chat", "--rps", "8", "--duration",
            "1.5", "--prefix-slots", "3", "--fail", "aw:1@0.9"]

    def lines(text):
        keep = ("requests finished", "prefix cache", "[orch", "[stall")
        return [ln.strip() for ln in text.splitlines()
                if ln.strip().startswith(keep)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--device", "cpu"] + args)
    got = lines(out.getvalue())
    # the reference with the port's one rule of the prefix cache: an entry
    # stops at its prefill-computed positions (tests/test_torch_prefixcache)
    offer = jprefixcache.PrefixCachePlane.offer
    monkeypatch.setattr(
        jprefixcache.PrefixCachePlane, "offer",
        lambda plane, r: offer(plane, dataclasses.replace(
            r, pos=min(r.pos, len(r.prompt) - 1))))
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    with contextlib.redirect_stdout(out):
        jserve.main()
    assert got == lines(out.getvalue())
    assert "prefix cache: 6 hits, 84 tokens adopted, 1 restored, 1 repins" \
        in got
    assert any("prefix_restored" in ln for ln in got)


def _load_reference_demo():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "failover_demo.py"
    spec = importlib.util.spec_from_file_location("reference_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_failover_demo_twin_matches_reference_demo():
    """The demo twin's four sections on the reference demo's weights:
    every stream equals the JAX demo's, EW and AW sections equal the
    reference section, the AW section's events and the session placements
    equal too."""
    jd = _load_reference_demo()
    want = {}
    with contextlib.redirect_stdout(io.StringIO()):
        eng = jd.build()
        params = params_from_reference(eng.params, device="cpu")
        jd.admit_all(eng)
        want["reference"] = jd.decode_all(eng)
        eng = jd.build()
        jd.admit_all(eng)
        for _ in range(5):
            eng.step()
        eng.fail_ew(0)
        want["ew"] = jd.decode_all(eng)
        eng = jd.build()
        orch = JOrch(eng, worker_init_time=2.0)
        jd.admit_all(eng)
        for _ in range(5):
            eng.step()
        orch.inject_failure("aw", 0, now=1.0)
        orch.tick(1.0 + orch.detection_latency())
        want["aw"] = jd.decode_all(eng)
        orch.tick(5.0)
        want["events"] = [(round(e.t, 2), e.kind, e.worker)
                          for e in orch.events]
        eng = jd.build(policy="session_affinity")
        for i in range(3):
            eng.gateway.enqueue(f"sess42-{i}", jd.PROMPTS[i], 4, now=0.0)
        eng.scheduler.admit(0.0)
        want["session"] = {r.rid: r.aw for r in eng.requests.values()}
    got = tdemo.main(device="cpu", params=params, log=lambda *a: None)
    assert {k: {r: list(t) for r, t in v.items()}
            for k, v in want.items() if k in ("reference", "ew", "aw")} == \
        {k: got[k] for k in ("reference", "ew", "aw")}
    assert got["ew"] == got["reference"] == got["aw"]
    assert got["events"] == want["events"]
    assert got["session"] == want["session"]
    assert len(set(got["session"].values())) == 1
