"""The port's forensics plane (serving/flightrec.py, launch/replay.py)
against the JAX package's: twins of ``tests/test_flightrec.py``.

  * the reference's incident (the reduced Mixtral at capacity factor 4,
    the reference's weights converted; ``mixed_slo`` at 3 rps for 2 s,
    ``fail_aw(0)`` at 0.4 s, preemption on, chunked prefill at 16, the
    watchdogs on): the port's bundle equals the reference's in
    ``records`` (fingerprints without ``config_hash``), ``submissions``,
    ``outputs``, ``request_states``, ``workers``, ``stalls``,
    ``truncated`` and ``health``, and in the loop, injection and
    orchestrator records;
  * inside the port: exact and script replay give the recorded streams
    bit for bit; recorder and watchdogs on equal off, with no new
    step-graph key; a bundle round-trips through its JSON; the ring keeps
    its capacity and counts its drops; autodump on detection;
    ``events.dropped``;
  * every refusal of the replay, with the reference's message;
  * the watchdogs: the incident stays quiet, and a seeded page leak, a
    corrupted pool and a stall regression trip at the same virtual time,
    with the same record, as the reference's.

The reference runs its incident once per module (``lru_cache``), and each
package's bundle of it is taken right after the run.
"""
import dataclasses
import functools
import json

import jax
import pytest

from repro.configs import get_config as jget_config
from repro.core.costmodel import TarragonProfile as JProfile
from repro.core.orchestrator import Orchestrator as JOrch
from repro.data.workloads import make_workload as jmake_workload
from repro.launch import replay as jreplay
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.scheduler import FailurePlan as JFailurePlan
from repro.serving.scheduler import run_serving as jrun_serving
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core.costmodel import TarragonProfile
from repro_torch.core.orchestrator import Orchestrator, WorkerEvent
from repro_torch.data.workloads import make_workload
from repro_torch.launch.replay import (BundleError, load_bundle,
                                       rebuild_engine_config,
                                       rebuild_model_config, replay_bundle)
from repro_torch.serving import flightrec
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.scheduler import FailurePlan, run_serving

STEP = 0.02
PF_TOK = 0.002
ENGINE = dict(max_batch=8, max_seq=96, num_aw=2, num_ew=2)
INCIDENT = dict(chunk_token_budget=16, preempt=True, telemetry=True,
                stall_threshold=0.1, flight_capacity=2048)
COMPARED = ("submissions", "outputs", "request_states", "workers",
            "stalls", "truncated", "health", "loops", "injections",
            "orchestrator", "open_spans", "clock", "controller")


def _cfg(get_config):
    cfg = get_config("mixtral_8x7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))


def _workload(mk):
    slo = mk("mixed_slo", rate_rps=3.0, duration=2.0, seed=7, max_new=40,
             interactive_deadline=0.3, batch_wave=8, batch_every=3.0)
    return sorted(slo, key=lambda r: (r.arrival, r.request_id))


@functools.lru_cache(maxsize=None)
def reference_incident():
    """The reference's AW-failure + preemption incident, and its bundle."""
    eng = JEngine(_cfg(jget_config), JEngineConfig(
        **ENGINE, **INCIDENT, flight_recorder=True, watchdogs=True),
        jax.random.PRNGKey(1))
    orch = JOrch(eng, profile=JProfile(detect=0.05, detect_retries=2),
                 worker_init_time=0.5)
    m = jrun_serving(eng, _workload(jmake_workload), duration=60.0,
                     orchestrator=orch, failures=[JFailurePlan(0.4, "aw", 0)],
                     step_time=STEP, prefill_token_time=PF_TOK)
    return eng, orch, m, eng.flightrec.dump(reason="twin")


@functools.lru_cache(maxsize=None)
def params():
    return params_from_reference(reference_incident()[0].params,
                                 device="cpu")


def make_engine(**kw):
    return InferenceEngine(_cfg(tget_config),
                           EngineConfig(**{**ENGINE, **kw}),
                           params=params(), device="cpu")


def _reference_engine(**kw):
    return JEngine(_cfg(jget_config), JEngineConfig(**{**ENGINE, **kw}),
                   jax.random.PRNGKey(1))


@functools.lru_cache(maxsize=None)
def incident(recording: bool):
    """The same incident on the port, recorder and watchdogs on or off;
    with the recorder on, its bundle is taken right after the run."""
    eng = make_engine(**INCIDENT, flight_recorder=recording,
                      watchdogs=recording)
    orch = Orchestrator(eng, profile=TarragonProfile(detect=0.05,
                                                     detect_retries=2),
                        worker_init_time=0.5)
    m = run_serving(eng, _workload(make_workload), duration=60.0,
                    orchestrator=orch, failures=[FailurePlan(0.4, "aw", 0)],
                    step_time=STEP, prefill_token_time=PF_TOK)
    bundle = eng.flightrec.dump(reason="twin") if recording else None
    return eng, orch, m, bundle


def copy(bundle):
    return json.loads(json.dumps(bundle))


def _records(bundle):
    out = []
    for r in bundle["records"]:
        r = dict(r)
        r.pop("config_hash", None)
        out.append(r)
    return out


# --------------------------------------------------------------------------
# the bundle, field for field against the reference's
# --------------------------------------------------------------------------

def test_bundle_equals_the_reference():
    *_, want = reference_incident()
    eng, orch, m, got = incident(True)
    assert eng.gateway.stats.preemptions >= 1
    assert any(e.kind == "detected" for e in orch.events)
    for k in COMPARED:
        assert got[k] == want[k], k
    assert _records(got) == _records(want)
    assert got["config"]["weights"] is None      # params were passed in
    assert got["schema"] == "repro_torch.postmortem.v1" != want["schema"]
    kinds = {r["kind"] for r in got["records"]}
    assert {"fail_aw", "detected", "restore", "preempted", "fingerprint",
            "submit", "chunk_commit"} <= kinds, kinds


# --------------------------------------------------------------------------
# ring capacity: bounded memory, counted drops, newest kept
# --------------------------------------------------------------------------

def test_ring_capacity_drops_oldest_and_counts():
    eng = make_engine(flight_capacity=16, telemetry=True)
    fr = eng.flightrec
    for i in range(50):
        eng.bus.publish(WorkerEvent(float(i), "synthetic", f"w{i}"))
    fr.tick(50.0)
    assert len(fr.records) == 16
    assert fr.records_total >= 50
    assert fr.records_dropped == fr.records_total - 16
    synth = [r["who"] for r in fr.records if r["kind"] == "synthetic"]
    assert synth[-1] == "w49" and "w0" not in synth
    eng.telemetry.sync()
    c = eng.telemetry.registry.counters
    assert c["flightrec.records_dropped"] == fr.records_dropped
    assert c["flightrec.records_total"] == fr.records_total
    assert eng.telemetry.registry.gauges["flightrec.records"] == 16
    b = fr.dump(reason="capacity test")
    assert b["truncated"]["records"] == fr.records_dropped


# --------------------------------------------------------------------------
# schema round trip
# --------------------------------------------------------------------------

def test_bundle_schema_roundtrip(tmp_path):
    eng, _, m, _ = incident(True)
    path = str(tmp_path / "incident.postmortem.json")
    eng.flightrec.dump(path, reason="roundtrip")
    b = load_bundle(path)
    assert b["schema"] == flightrec.SCHEMA
    for k in ("reason", "clock", "config", "loops", "orchestrator",
              "injections", "records", "submissions", "outputs",
              "request_states", "workers", "open_spans", "stalls",
              "truncated", "health"):
        assert k in b, k
    assert flightrec.hash_config_dicts(
        b["config"]["model"], b["config"]["engine"]) == b["config"]["hash"]
    assert rebuild_model_config(b["config"]["model"]) == eng.cfg
    assert rebuild_engine_config(b["config"]["engine"], "exact") == \
        dataclasses.replace(eng.ecfg, flight_autodump="",
                            trace_export_path="")
    assert b["outputs"] == m.outputs
    assert eng.flightrec.last_dump_path == path


# --------------------------------------------------------------------------
# replay: exact and script, bit for bit inside the port
# --------------------------------------------------------------------------

def test_exact_replay_of_the_incident(tmp_path):
    _, _, m, bundle = incident(True)
    path = tmp_path / "incident.postmortem.json"
    path.write_text(json.dumps(bundle))
    report = replay_bundle(load_bundle(str(path)), params=params(),
                           device="cpu")
    assert report["config_hash_ok"]
    assert report["mismatched"] == [] and report["missing"] == []
    assert report["matched"] == len(m.outputs) > 0
    assert report["failures_injected"] == 1
    assert report["ok"]


@pytest.fixture(scope="module")
def seeded_run(tmp_path_factory):
    """An engine that drew its own weights (seed 3), autodump on, through
    six requests and an AW failure at 0.3 s."""
    path = str(tmp_path_factory.mktemp("autodump") / "auto.postmortem.json")
    eng = InferenceEngine(_cfg(tget_config), EngineConfig(
        **ENGINE, chunk_token_budget=16, flight_autodump=path), seed=3,
        device="cpu")
    orch = Orchestrator(eng, profile=TarragonProfile(detect=0.05,
                                                     detect_retries=2),
                        worker_init_time=0.5)
    m = run_serving(eng, _workload(make_workload)[:6], duration=60.0,
                    orchestrator=orch, failures=[FailurePlan(0.3, "aw", 0)],
                    step_time=STEP, prefill_token_time=PF_TOK)
    return eng, m, path


def test_exact_replay_of_a_seed_built_engine(seeded_run):
    """A bundle of an engine that drew its own weights names their seed;
    the replay rebuilds them and needs no params."""
    eng, m, _ = seeded_run
    bundle = copy(eng.flightrec.dump(reason="seeded"))
    assert bundle["config"]["weights"] == {"seed": 3}
    report = replay_bundle(bundle, device="cpu")
    assert report["ok"] and report["matched"] == len(m.outputs) > 0


def test_script_replay_of_a_controller_incident():
    """Controller off, its recorded decisions applied as a script: the
    decisions, not the decider, determined the outcome."""
    wl = make_workload("mixed_slo", rate_rps=3.0, duration=3.0, seed=7,
                       interactive_deadline=0.3)
    wl = [dataclasses.replace(w, prompt_len=min(w.prompt_len, 16),
                              max_new_tokens=min(w.max_new_tokens, 8))
          for w in wl]
    eng = make_engine(max_seq=64, max_ew=4, chunk_token_budget=32,
                      prefill_token_cap=256, controller="on")
    orch = Orchestrator(eng, worker_init_time=0.4, weight_push_time=0.2)
    m = run_serving(eng, wl, 60.0, orchestrator=orch, step_time=STEP,
                    prefill_token_time=PF_TOK)
    assert eng.controller.decisions
    bundle = copy(eng.flightrec.dump(reason="controller incident"))
    assert bundle["controller"]["decisions"] == eng.controller.decisions
    report = replay_bundle(bundle, mode="script", params=params(),
                           device="cpu")
    assert report["ok"], report
    assert report["matched"] == len(m.outputs) > 0
    assert report["scale_events"] == sum(
        1 for d in eng.controller.decisions
        if d["kind"] in ("scale_out", "scale_in", "rebalance"))


# --------------------------------------------------------------------------
# every refusal, with the reference's message
# --------------------------------------------------------------------------

def _refusal(fn, bundle, **kw):
    with pytest.raises(BundleError if fn is replay_bundle
                       else jreplay.BundleError) as e:
        fn(bundle, **kw)
    return str(e.value)


def test_replay_refusals_match_the_reference():
    *_, jb = reference_incident()
    *_, tb = incident(True)
    port = dict(params=params(), device="cpu")

    def wall(b):
        b["loops"][0]["step_time"] = None

    def trunc(b):
        b["truncated"]["submissions"] = 3

    def trunc_out(b):
        b["truncated"]["outputs"] = 2

    def loops(b):
        b["loops"].append(dict(b["loops"][0]))

    def no_orch(b):
        b["orchestrator"] = None

    def sampling(b):
        b["submissions"][0]["sampling"] = {"greedy": False}

    cases = [("wall-clock", wall, "exact"), ("truncated", trunc, "exact"),
             ("truncated", trunc_out, "exact"),
             ("serving loops", loops, "exact"),
             ("orchestrator", no_orch, "exact"),
             ("client-API", sampling, "exact")]
    for word, mutate, mode in cases:
        j, t = copy(jb), copy(tb)
        mutate(j)
        mutate(t)
        want = _refusal(jreplay.replay_bundle, j, mode=mode)
        got = _refusal(replay_bundle, t, mode=mode, **port)
        assert got == want and word in got, (got, want)

    # script mode cannot replay controller-chosen victims
    j, t = copy(jb), copy(tb)
    for b in (j, t):
        b["config"]["engine"].update(controller="on",
                                     victim_policy="controller")
    want = _refusal(jreplay.replay_bundle, j, mode="script")
    got = _refusal(replay_bundle, t, mode="script", **port)
    assert got == want and "victim_policy" in got

    # a bundle of the other package names weights the port cannot build,
    # and a bundle of passed-in weights needs them
    assert "unsupported bundle schema 'repro.postmortem.v1'" in \
        _refusal(replay_bundle, copy(jb), **port)
    assert "weights: null" in _refusal(replay_bundle, copy(tb),
                                       device="cpu")


# --------------------------------------------------------------------------
# recorder and watchdogs on == off, no new step-graph key
# --------------------------------------------------------------------------

def test_recorder_on_off_bit_identical_with_no_new_capture():
    eng_on, _, m_on, _ = incident(True)
    eng_off, _, m_off, _ = incident(False)
    assert eng_on.flightrec is not None and eng_off.flightrec is None
    assert m_on.outputs == m_off.outputs
    assert m_on.finished == m_off.finished
    assert eng_on.decode_plane.captures() == \
        eng_off.decode_plane.captures()
    assert eng_on.gateway.stats.host_syncs == \
        eng_off.gateway.stats.host_syncs
    # the flight recorder is on by default, as in the reference
    assert EngineConfig().flight_recorder and \
        JEngineConfig().flight_recorder
    assert not EngineConfig().watchdogs


# --------------------------------------------------------------------------
# health watchdogs, trip for trip against the reference
# --------------------------------------------------------------------------

def test_clean_incident_run_no_watchdog_trips():
    eng, *_ = incident(True)
    wd = eng.flightrec.watchdogs
    assert wd is not None and wd.intervals > 0
    assert wd.trips == []
    assert wd.intervals == reference_incident()[0].flightrec \
        .watchdogs.intervals


WD = dict(kv_page_tokens=16, chunk_token_budget=16, watchdogs=True,
          wd_interval=0.1, wd_window=4, wd_settle=0.0)


def _soak(eng, leak: bool):
    fr = eng.flightrec
    now = 0.0
    for i in range(40):
        if leak:
            assert eng.pages.alloc(i % eng.ecfg.num_aw) > 0
        fr.tick(now)
        now += 0.05
    return fr.watchdogs


def test_seeded_page_leak_trips_as_the_reference():
    kw = dict(WD, wd_leak_min_drop=3)
    wd = _soak(make_engine(**kw), leak=True)
    want = _soak(_reference_engine(**kw), leak=True)
    assert wd.trip_counts.get("leak", 0) >= 1, wd.trips
    assert wd.trips == want.trips
    assert wd.summary() == want.summary()
    trip = next(t for t in wd.trips if t["kind"] == "leak")
    assert trip["what"] == "pages"
    assert trip["watermarks"] == sorted(trip["watermarks"], reverse=True)
    assert wd.trip_counts.get("invariant", 0) == 0
    clean = _soak(make_engine(**kw), leak=False)
    assert clean.trips == []


def test_invariant_probe_trips_on_corrupted_pool_as_the_reference():
    wds = []
    for eng in (make_engine(**WD), _reference_engine(**WD)):
        pid = eng.pages.alloc(0)
        eng.pages._free[0].append(pid)       # allocated AND free
        fr = eng.flightrec
        for i in range(10):
            fr.tick(i * 0.05)
        wds.append(fr.watchdogs)
    wd, want = wds
    assert wd.trip_counts.get("invariant", 0) == 1, wd.trips
    assert "allocated AND free" in wd.trips[0]["detail"]
    assert [(t["t"], t["kind"], t["what"]) for t in wd.trips] == \
        [(t["t"], t["kind"], t["what"]) for t in want.trips]


def test_stall_regression_trips_as_the_reference():
    kw = dict(telemetry=True, watchdogs=True, wd_interval=0.1, wd_window=4,
              wd_stall_factor=2.0, wd_settle=0.0, stall_threshold=0.1)
    wds = []
    for eng in (make_engine(**kw), _reference_engine(**kw)):
        wd = eng.flightrec.watchdogs
        h = eng.telemetry.registry.hist("tbt")
        now = 0.0
        for _ in range(3):
            for _ in range(20):
                h.observe(0.02)
            now += 0.11
            wd.tick(now)
        assert wd.baseline_p99.get("tbt") is not None and wd.trips == []
        for _ in range(20):
            h.observe(1.0)
        now += 0.11
        wd.tick(now)
        wds.append(wd)
    wd, want = wds
    assert wd.trip_counts.get("stall_regression", 0) == 1, wd.trips
    assert wd.trips[-1]["what"] == "tbt"
    assert wd.trips == want.trips
    assert wd.baseline_p99 == want.baseline_p99


def test_watchdog_trips_emit_health_events():
    eng = make_engine(**WD, telemetry=True, wd_leak_min_drop=3)
    _soak(eng, leak=True)
    assert any(e.kind == "health_leak" for e in eng.bus.events)
    eng.telemetry.sync()
    c = eng.telemetry.registry.counters
    assert c["health.trips"] >= 1
    assert c["health.trips.leak"] >= 1
    assert eng.telemetry.registry.gauges["health.intervals"] == \
        eng.flightrec.watchdogs.intervals


# --------------------------------------------------------------------------
# autodump on failure detection
# --------------------------------------------------------------------------

def test_autodump_on_failure_detection(seeded_run):
    eng, _, path = seeded_run
    b = load_bundle(path)
    assert b["reason"].startswith("failure detected")
    # dumped at detection: the incident window is open, not done
    assert len(b["outputs"]) < len(eng.flightrec.outputs)
    assert eng.flightrec._autodumped
    # the replay never overwrites the incident's bundle
    assert rebuild_engine_config(b["config"]["engine"],
                                 "exact").flight_autodump == ""


# --------------------------------------------------------------------------
# events.dropped (bus cap drops) and the live-recorder dump
# --------------------------------------------------------------------------

def test_events_dropped_counter_surfaces_bus_cap_drops():
    eng = make_engine(telemetry=True)
    eng.bus.max_events = len(eng.bus.events) + 2
    for i in range(6):
        eng.bus.publish(WorkerEvent(0.0, "storm", f"w{i}"))
    assert eng.bus.dropped == 4
    eng.telemetry.sync()
    reg = eng.telemetry.registry
    assert reg.counters["events.dropped"] == 4
    assert "events_dropped_total 4" in reg.prometheus_text()


def test_dump_live_recorders(tmp_path):
    eng = make_engine()
    assert eng.flightrec in flightrec._LIVE
    paths = flightrec.dump_live_recorders(str(tmp_path), "a/b::c", limit=1)
    assert paths == [str(tmp_path /
                         f"a_b__c.r{eng.flightrec.serial}.postmortem.json")]
    b = load_bundle(paths[0])
    assert b["reason"] == "test failure: a/b::c"
