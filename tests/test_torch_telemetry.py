"""The port's telemetry plane (serving/telemetry.py) against the JAX
package's: twins of the 23 tests of ``tests/test_telemetry.py``.

The pure pieces (percentiles, streaming histograms, the registry and its
Prometheus text, the event bus, ``timeline_from_bus``, ``attribute_gap``)
give the reference's outputs on the same inputs. The scenario (an AW
failure, preemptions, a queued cancel and prefix-warm chat turns through
``run_serving`` at a fixed ``step_time`` and ``prefill_token_time``) runs
on both packages (the reduced Mixtral at capacity factor 4; the port with
the reference's weights, converted): the streams, the registry's counters,
the per-class histograms, the stall records and the root-span counts equal
the reference's, and inside the port telemetry on and off give the same
streams, the same step-graph keys and the same host-sync count ("zero new
jit traces" reads "no new step graph": ``decode_plane.captures()``). The
reference runs with the port's one rule of the prefix cache applied (an
entry stops at its prefill-computed positions; see
``tests/test_torch_prefixcache.py``), so that warm turns adopt, and the
virtual clock charges, the same tokens in both.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.costmodel import TarragonProfile as JProfile
from repro.core.events import timeline_from_bus as jtimeline_from_bus
from repro.core.orchestrator import Orchestrator as JOrch
from repro.core.orchestrator import WorkerEvent as JWorkerEvent
from repro.data.workloads import make_workload as jmake_workload
from repro.serving import prefixcache as jprefixcache
from repro.serving import telemetry as jtel
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.scheduler import FailurePlan as JFailurePlan
from repro.serving.scheduler import run_serving as jrun_serving
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core.costmodel import TarragonProfile
from repro_torch.core.events import timeline_from_bus
from repro_torch.core.orchestrator import Orchestrator, WorkerEvent
from repro_torch.data.workloads import make_workload
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.scheduler import FailurePlan, run_serving
from repro_torch.serving.telemetry import (SCHEMA, STALL_CAUSES, EventBus,
                                           MetricsRegistry,
                                           StreamingHistogram, attribute_gap,
                                           pct, summarize_latency)

STEP = 0.02
PF_TOK = 0.002
REFERENCE_OFFER = jprefixcache.PrefixCachePlane.offer


def _capped_offer(plane, r):
    return REFERENCE_OFFER(plane, dataclasses.replace(
        r, pos=min(r.pos, len(r.prompt) - 1)))


def _cfg(get_config):
    cfg = get_config("mixtral_8x7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))


# --------------------------------------------------------------------------
# percentile helpers
# --------------------------------------------------------------------------

def test_pct_empty_guard():
    assert pct([], 50) == 0.0
    assert pct(np.zeros((0,)), 99) == 0.0
    assert pct([3.0, 1.0, 2.0], 50) == 2.0
    vals = np.random.default_rng(3).exponential(size=101)
    for q in (0, 50, 95, 99, 100):
        assert pct(vals, q) == jtel.pct(vals, q)


def test_summarize_latency():
    s = summarize_latency([])
    assert s["n"] == 0 and s["p99"] == 0.0
    s = summarize_latency([0.1] * 100)
    assert s["n"] == 100
    assert s["p50"] == pytest.approx(0.1)
    assert s["max"] == pytest.approx(0.1)
    vals = np.random.default_rng(4).lognormal(size=57)
    assert summarize_latency(vals) == jtel.summarize_latency(vals)


# --------------------------------------------------------------------------
# streaming histogram
# --------------------------------------------------------------------------

def exact_rank(vals: np.ndarray, q: float) -> float:
    v = np.sort(np.asarray(vals))
    k = min(v.size - 1, max(0, math.ceil(q * v.size) - 1))
    return float(v[k])


def within_one_bucket(h, streamed: float, exact: float) -> bool:
    return abs(h.bucket_index(streamed) - h.bucket_index(exact)) <= 1


def test_histogram_quantiles_within_one_bucket():
    vals = np.random.default_rng(0).lognormal(mean=-3.0, sigma=1.2,
                                              size=5000)
    h, ref = StreamingHistogram(), jtel.StreamingHistogram()
    for v in vals:
        h.observe(v)
        ref.observe(v)
    assert h.count == vals.size
    for q in (0.0, 0.50, 0.95, 0.99, 1.0):
        assert h.quantile(q) == ref.quantile(q)
    for q in (0.50, 0.95, 0.99):
        assert within_one_bucket(h, h.quantile(q), exact_rank(vals, q))
    assert h.quantile(0.0) >= float(vals.min()) - 1e-12
    assert h.quantile(1.0) <= float(vals.max()) + 1e-12
    assert h.snapshot() == ref.snapshot()


def test_histogram_constant_memory():
    h = StreamingHistogram()
    n_buckets = h.counts.size
    for v in np.random.default_rng(1).exponential(size=10000):
        h.observe(v)
    assert h.counts.size == n_buckets == jtel.StreamingHistogram().counts.size
    assert h.count == 10000


def test_histogram_merge_equals_union():
    rng = np.random.default_rng(2)
    a, b = rng.exponential(size=400), rng.exponential(size=700)
    ha, hb, hu = (StreamingHistogram() for _ in range(3))
    ra, rb = jtel.StreamingHistogram(), jtel.StreamingHistogram()
    for v in a:
        ha.observe(v)
        hu.observe(v)
        ra.observe(v)
    for v in b:
        hb.observe(v)
        hu.observe(v)
        rb.observe(v)
    ha.merge(hb)
    ra.merge(rb)
    assert ha.count == hu.count == 1100
    assert np.array_equal(ha.counts, hu.counts)
    assert ha.vmax == hu.vmax and ha.vmin == hu.vmin
    for q in (0.5, 0.99):
        assert ha.quantile(q) == hu.quantile(q) == ra.quantile(q)


def test_histogram_merge_rejects_incompatible_configs():
    with pytest.raises(AssertionError):
        StreamingHistogram(buckets_per_decade=32).merge(
            StreamingHistogram(buckets_per_decade=16))


def test_registry_snapshot_and_prometheus():
    ours, ref = MetricsRegistry(), jtel.MetricsRegistry()
    for r in (ours, ref):
        r.inc("requests.released", 3)
        r.gauge("queue_depth", 5.0)
        r.observe("ttft", 0.12)
        r.observe("ttft", 0.34)
    snap = ours.snapshot()
    assert snap["schema"] == SCHEMA == jtel.SCHEMA
    assert snap == ref.snapshot()
    assert snap["counters"]["requests.released"] == 3
    assert snap["histograms"]["ttft"]["count"] == 2
    text = ours.prometheus_text()
    assert text == ref.prometheus_text()
    assert "tarragon_requests_released_total 3" in text
    assert 'tarragon_ttft_bucket{le="+Inf"} 2' in text


# --------------------------------------------------------------------------
# event bus
# --------------------------------------------------------------------------

def _ev(t, kind, worker="aw0"):
    return WorkerEvent(t, kind, worker)


def test_event_bus_multi_consumer_non_stealing():
    bus = EventBus()
    for i in range(3):
        bus.publish(_ev(float(i), "detected"))
    assert len(bus.drain("a")) == 3
    assert len(bus.drain("b")) == 3
    assert len(bus.drain("a")) == 0
    bus.publish(_ev(3.0, "provisioned"))
    assert [e.kind for e in bus.drain("a")] == ["provisioned"]
    assert [e.kind for e in bus.drain("b")] == ["provisioned"]
    assert len(bus.events) == 4
    assert len(bus.drain("late")) == 4
    assert bus.cursor("a") == 4


def test_event_bus_cap_drops_newest_keeps_cursors_valid():
    bus, ref = EventBus(max_events=4), jtel.EventBus(max_events=4)
    for i in range(6):
        bus.publish(_ev(float(i), "k"))
        ref.publish(JWorkerEvent(float(i), "k", "aw0"))
    assert len(bus) == len(ref) == 4 and bus.dropped == ref.dropped == 2
    assert [e.t for e in bus.drain("x")] == [e.t for e in ref.drain("x")] \
        == [0.0, 1.0, 2.0, 3.0]


def test_timeline_from_bus_is_a_second_consumer():
    bus, ref = EventBus(), jtel.EventBus()
    for ev_cls, b in ((WorkerEvent, bus), (JWorkerEvent, ref)):
        b.publish(ev_cls(0.5, "detected", "aw0", "heartbeat"))
        b.publish(ev_cls(1.0, "provisioned", "aw2"))
    audit = bus.drain("audit")
    lines = timeline_from_bus(bus)
    assert len(audit) == 2
    assert lines == jtimeline_from_bus(ref) == [
        "detected@0.50s aw0 (heartbeat)", "provisioned@1.00s aw2"]
    assert timeline_from_bus(bus) == []
    assert len(bus.events) == 2


# --------------------------------------------------------------------------
# stall attribution
# --------------------------------------------------------------------------

def test_attribute_gap_sums_exactly_and_prioritises():
    causes = {"detection": [(-1.0, 3.0)], "queue_wait": [(2.0, 5.0)],
              "prefill": [(4.5, 5.5)], "restore": [(6.0, 6.5), (6.2, 7.0)],
              "rebalance": [(8.0, 12.0)]}
    comps = attribute_gap(0.0, 10.0, causes)
    assert comps == jtel.attribute_gap(0.0, 10.0, causes)
    assert comps["detection"] == pytest.approx(3.0)
    assert comps["queue_wait"] == pytest.approx(2.0)
    assert comps["prefill"] == pytest.approx(0.5)
    assert sum(comps.values()) == pytest.approx(10.0, abs=1e-12)


def test_attribute_gap_empty_causes_is_all_execution():
    comps = attribute_gap(1.0, 2.5, {})
    assert comps == jtel.attribute_gap(1.0, 2.5, {})
    assert comps["execution"] == pytest.approx(1.5)
    assert all(comps[c] == 0.0 for c in STALL_CAUSES)
    assert STALL_CAUSES == jtel.STALL_CAUSES


# --------------------------------------------------------------------------
# the scenario: AW failure, preemptions, a queued cancel and prefix-warm
# chat turns, on both packages and, in the port, telemetry on and off
# --------------------------------------------------------------------------

_RUNS = {}


def _workload(mk):
    slo = mk("mixed_slo", rate_rps=3.0, duration=2.0, seed=7, max_new=40,
             interactive_deadline=0.3, batch_wave=8, batch_every=3.0)
    chat = mk("multi_turn_chat", rate_rps=3.0, duration=2.0, seed=11,
              chat_turns=2, chat_turn_gap=0.6, chat_max_new=4)
    return sorted(slo + chat, key=lambda r: (r.arrival, r.request_id))


def scenario(pkg: str, telemetry: bool = True):
    """One serving run (cached), as the reference test's ``scenario``."""
    key = (pkg, telemetry)
    if key in _RUNS:
        return _RUNS[key]
    opts = dict(max_batch=8, max_seq=96, num_aw=2, num_ew=2,
                chunk_token_budget=16, prefix_cache_slots=4, preempt=True,
                placement="session_affinity", telemetry=telemetry,
                stall_threshold=0.1)
    if pkg == "jax":
        jprefixcache.PrefixCachePlane.offer = _capped_offer
        eng = JEngine(_cfg(jget_config), JEngineConfig(**opts),
                      jax.random.PRNGKey(1))
        orch = JOrch(eng, profile=JProfile(detect=0.05, detect_retries=2),
                     worker_init_time=0.5)
        serve, fail, wl = jrun_serving, JFailurePlan, _workload(
            jmake_workload)
    else:
        params = params_from_reference(scenario("jax")[0].params,
                                       device="cpu")
        eng = InferenceEngine(_cfg(tget_config), EngineConfig(**opts),
                              params=params, device="cpu")
        orch = Orchestrator(eng, profile=TarragonProfile(
            detect=0.05, detect_retries=2), worker_init_time=0.5)
        serve, fail, wl = run_serving, FailurePlan, _workload(make_workload)
    # cancelled while still queued: its root span closes through the drop
    eng.gateway.enqueue("cx", np.arange(1, 9, dtype=np.int32), 4, now=0.0)
    assert eng.cancel_request("cx", now=0.0)
    try:
        m = serve(eng, wl, duration=60.0, orchestrator=orch,
                  failures=[fail(0.4, "aw", 0)], step_time=STEP,
                  prefill_token_time=PF_TOK)
    finally:
        jprefixcache.PrefixCachePlane.offer = REFERENCE_OFFER
    _RUNS[key] = (eng, orch, m, wl)
    return _RUNS[key]


def test_scenario_covers_every_path():
    eng, orch, m, wl = scenario("port")
    assert len(m.finished) == len(wl)
    assert eng.gateway.stats.preemptions >= 1
    assert eng.gateway.stats.prefix_hits >= 1
    assert eng.store.stats.restores >= 1
    assert any(e.kind == "detected" for e in orch.events)
    jeng, jorch, jm, _ = scenario("jax")
    assert m.outputs == jm.outputs and m.finished == jm.finished
    assert [(e.t, e.kind, e.worker, e.detail) for e in orch.events] == \
        [(e.t, e.kind, e.worker, e.detail) for e in jorch.events]
    assert [(e.t, e.kind, e.worker, e.detail) for e in eng.bus.events] == \
        [(e.t, e.kind, e.worker, e.detail) for e in jeng.bus.events]


def test_telemetry_on_off_bit_identical():
    _, _, m_on, _ = scenario("port", True)
    _, _, m_off, _ = scenario("port", False)
    assert set(m_on.outputs) == set(m_off.outputs)
    for rid, toks in m_off.outputs.items():
        assert m_on.outputs[rid] == toks, rid
    assert m_on.finished == m_off.finished
    assert m_on.telemetry is not None and m_off.telemetry is None


def test_telemetry_mints_zero_new_jit_traces():
    """No new step graph: the same keys on and off (on the card each key is
    one capture), the snapshot's gauge agrees, and a decode step keeps its
    one host sync (the token drain)."""
    eng_on, _, _, _ = scenario("port", True)
    eng_off, _, _, _ = scenario("port", False)
    assert set(eng_on.decode_plane.graphs) == set(eng_off.decode_plane.graphs)
    assert eng_on.gateway.stats.host_syncs == \
        eng_off.gateway.stats.host_syncs == scenario("jax")[0].gateway.stats.\
        host_syncs
    snap = eng_on.telemetry.snapshot()
    assert snap["gauges"]["graph.decode_captures"] == \
        eng_on.decode_plane.captures()


def test_every_request_closes_exactly_one_root_span():
    eng, _, m, wl = scenario("port")
    tel = m.telemetry
    rids = {w.request_id for w in wl} | {"cx"}
    assert set(tel.closed_roots) == rids
    assert all(n == 1 for n in tel.closed_roots.values()), tel.closed_roots
    assert tel.closed_roots == scenario("jax")[2].telemetry.closed_roots
    assert not tel._root and not tel._phase
    snap = tel.snapshot()
    assert snap["spans"]["open_roots"] == 0
    assert snap["counters"]["requests.outcome.cancelled"] == 1
    assert snap["counters"]["requests.outcome.done"] == len(wl)


def test_stall_components_sum_to_gap():
    _, _, m, _ = scenario("port")
    rep = m.telemetry.stall_report()
    assert rep
    for s in rep:
        assert s["gap"] > m.telemetry.stall_threshold
        assert abs(sum(s["components"].values()) - s["gap"]) < 1e-9, s
        assert all(v >= -1e-12 for v in s["components"].values()), s
    causes = {c for s in rep
              for c, v in s["components"].items() if v > 1e-12}
    assert {"restore", "preemption", "execution"} <= causes, causes
    assert rep == scenario("jax")[2].telemetry.stall_report()


def test_streamed_percentiles_match_exact_within_one_bucket():
    _, _, m, _ = scenario("port")
    tel = m.telemetry
    tbt_e, ttft_e = m.tbt_values(), m.ttft_values()
    h_tbt, h_ttft = tel.registry.hist("tbt"), tel.registry.hist("ttft")
    assert h_tbt.count == tbt_e.size
    assert h_ttft.count == ttft_e.size
    assert h_tbt.quantile(0.5) == pytest.approx(exact_rank(tbt_e, 0.5),
                                                rel=0.08)
    for h, vals in ((h_tbt, tbt_e), (h_ttft, ttft_e)):
        for q in (0.50, 0.95, 0.99):
            assert within_one_bucket(h, h.quantile(q), exact_rank(vals, q))
    assert h_tbt.total == pytest.approx(float(tbt_e.sum()), rel=1e-6)
    ref = scenario("jax")[2].telemetry.registry
    for name in ("tbt", "ttft", "queue_delay"):
        assert tel.registry.hist(name).snapshot() == \
            ref.hist(name).snapshot(), name


def test_per_class_histograms_partition_the_stream():
    _, _, m, _ = scenario("port")
    tel = m.telemetry
    ref = scenario("jax")[2].telemetry.registry
    classes = set(m.slo_class.values())
    assert {"interactive", "batch", "standard"} <= classes
    n_by_class = sum(tel.registry.hist(f"tbt.{c}").count for c in classes)
    assert n_by_class == tel.registry.hist("tbt").count
    for c in classes:
        assert tel.registry.hist(f"tbt.{c}").count == m.tbt_values(c).size
        for name in (f"tbt.{c}", f"ttft.{c}", f"queue_delay.{c}"):
            assert tel.registry.hist(name).snapshot() == \
                ref.hist(name).snapshot(), name


def test_snapshot_schema_and_mirrored_stats():
    eng, _, m, _ = scenario("port")
    snap = m.telemetry.snapshot()
    assert snap["schema"] == SCHEMA
    for key in ("counters", "gauges", "histograms", "clock", "stalls",
                "spans"):
        assert key in snap, key
    gs = eng.gateway.stats
    assert snap["counters"]["gateway.preemptions"] == gs.preemptions
    assert snap["counters"]["gateway.prefix_hits"] == gs.prefix_hits
    assert snap["counters"]["events.preempted"] == gs.preemptions
    assert snap["gauges"]["gateway.queue_depth"] == 0
    assert snap["gauges"]["ew.live"] == len(eng.live_ews)
    assert snap["histograms"]["queue_delay"]["count"] >= len(m.queue_delay)
    assert json.loads(json.dumps(snap)) == snap
    ref = scenario("jax")[2].telemetry.snapshot()
    assert snap["counters"] == ref["counters"]
    assert snap["clock"] == ref["clock"] and snap["spans"] == ref["spans"]
    assert snap["histograms"] == ref["histograms"]


def test_prometheus_export_shape():
    _, _, m, _ = scenario("port")
    lines = m.telemetry.prometheus_text().splitlines()
    assert any(ln.startswith("tarragon_ttft_bucket{le=") for ln in lines)
    assert any('le="+Inf"' in ln for ln in lines)
    assert any(ln.startswith("tarragon_gateway_admitted_total ")
               for ln in lines)
    cum = [float(ln.rsplit(" ", 1)[1]) for ln in lines
           if ln.startswith("tarragon_tbt_bucket{")]
    assert cum == sorted(cum) and cum[-1] > 0
    ref = scenario("jax")[2].telemetry.prometheus_text().splitlines()
    # every counter and histogram line equals the reference's (gauges
    # name the port's own step-graph count)
    keep = ("_total ", "_bucket{", "_sum ", "_count ")
    assert [ln for ln in lines if any(k in ln for k in keep)] == \
        [ln for ln in ref if any(k in ln for k in keep)]


def test_chrome_trace_export(tmp_path):
    eng, orch, m, wl = scenario("port")
    path = tmp_path / "trace.json"
    trace = m.telemetry.export_chrome(str(path))
    assert json.loads(path.read_text()) == trace
    evs = trace["traceEvents"]
    assert any(e["ph"] == "M" and e["name"] == "thread_name" for e in evs)
    xs = [e for e in evs if e["ph"] == "X"]
    assert xs and all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)
    det = [e for e in xs if e["name"].startswith("detect_aw")]
    assert len(det) == 1
    t_detect = next(e.t for e in orch.events if e.kind == "detected")
    assert det[0]["ts"] + det[0]["dur"] == pytest.approx(t_detect * 1e6)
    stall = [e for e in xs if e["name"].startswith("stall(")]
    assert stall and any(e["args"].get("restore", 0) > 0 for e in stall)
    assert {w.request_id for w in wl} <= {e["name"] for e in xs}
    ref = scenario("jax")[2].telemetry.export_chrome()
    assert [(e["ph"], e["name"]) for e in evs] == \
        [(e["ph"], e["name"]) for e in ref["traceEvents"]]


def test_telemetry_off_engine_has_no_plane():
    eng, _, _, _ = scenario("port", False)
    assert eng.telemetry is None
    assert eng.gateway.telemetry is None
    assert len(eng.bus.events) > 0
    assert len(eng.bus.events) == len(scenario("port", True)[0].bus.events)


def test_quickstart_twin_on_cpu(tmp_path):
    """The quickstart twin reads the telemetry plane and writes its Chrome
    trace: one root span per request, every request released."""
    from repro_torch.examples import quickstart
    path = tmp_path / "trace.json"
    out = quickstart.main(["--device", "cpu", "--requests", "2",
                           "--tokens", "4", "--trace", str(path)],
                          log=lambda *a: None)
    trace = json.loads(path.read_text())
    assert trace == out["trace"]
    roots = [e for e in trace["traceEvents"]
             if e["ph"] == "X" and e.get("cat") == "request"]
    assert sorted(e["name"] for e in roots) == ["req0", "req1"]
    assert out["snapshot"]["counters"]["requests.released"] == 2
    assert [len(out[r]) for r in ("req0", "req1")] == [4, 4]
