"""The port's control plane (serving/controller.py) against the JAX
package's: twins of ``tests/test_controller.py``.

  * the reference's scenario (the reduced Mixtral at capacity factor 4,
    the reference's weights converted; ``mixed_slo`` at 3 rps for 5 s with
    the controller on and ``victim_policy="controller"``): the same
    decision list (t, kind, detail, fields), counts, streams,
    orchestrator events and ``controller.*`` / ``events.controller_*``
    registry values as the reference engine;
  * inside the port: controller on equals its decisions replayed as a
    script on a controller-off engine, bit for bit, and the loop adds no
    step-graph key after warm-up; no flapping under an oscillating queue;
    the preemption gate and interactive immunity; the victim pricing;
    controller off is the default and inert;
  * the weighted replica packer's plans against the reference manager's
    on seeded loads;
  * both launchers with ``--controller --workload mixed_slo``: equal
    ``[ctl ...]`` and ``[orch ...]`` lines; the ``serve_workload`` twin
    with ``--controller`` under an AW failure records an incident that
    replays bit for bit.

The reference runs its scenario once per module (``lru_cache``); every
port engine is built from its converted weights.
"""
import contextlib
import dataclasses
import functools
import io
import sys

import jax
import numpy as np

from repro.configs import get_config as jget_config
from repro.core import ert as jert
from repro.core import placement as jpl
from repro.core.orchestrator import Orchestrator as JOrch
from repro.data.workloads import make_workload as jmake_workload
from repro.launch import serve as jserve
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.scheduler import run_serving as jrun_serving
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core import ert as tert
from repro_torch.core import placement as tpl
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.data.workloads import make_workload
from repro_torch.examples import serve_workload as tserve_workload
from repro_torch.launch import serve as tserve
from repro_torch.launch.replay import load_bundle, replay_bundle
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.scheduler import ScalePlan, run_serving

PROMPT = np.arange(1, 9, dtype=np.int32)
ENGINE = dict(max_batch=8, max_seq=64, num_aw=2, num_ew=2)
LOOP = dict(max_ew=4, chunk_token_budget=32, prefill_token_cap=256)
ORCH = dict(worker_init_time=0.4, weight_push_time=0.2)
CLOCK = dict(step_time=0.02, prefill_token_time=0.002)


def _cfg(get_config):
    cfg = get_config("mixtral_8x7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))


def mixed_workload(mk, duration=5.0):
    wl = mk("mixed_slo", rate_rps=3.0, duration=duration, seed=7,
            interactive_deadline=0.3)
    return [dataclasses.replace(w, prompt_len=min(w.prompt_len, 16),
                                max_new_tokens=min(w.max_new_tokens, 8))
            for w in wl]


@functools.lru_cache(maxsize=None)
def reference_run():
    """The reference's telemetry scenario: controller on, controller
    victims, every policy active."""
    eng = JEngine(_cfg(jget_config), JEngineConfig(
        **ENGINE, **LOOP, controller="on", victim_policy="controller"),
        jax.random.PRNGKey(0))
    orch = JOrch(eng, **ORCH)
    m = jrun_serving(eng, mixed_workload(jmake_workload), 60.0,
                     orchestrator=orch, **CLOCK)
    return eng, orch, m


@functools.lru_cache(maxsize=None)
def port_params():
    return params_from_reference(reference_run()[0].params, device="cpu")


def make_engine(**kw):
    return InferenceEngine(_cfg(tget_config),
                           EngineConfig(**{**ENGINE, **kw}),
                           params=port_params(), device="cpu")


@functools.lru_cache(maxsize=None)
def port_run(victim_policy="controller", warm=False):
    eng = make_engine(**LOOP, controller="on", victim_policy=victim_policy)
    orch = Orchestrator(eng, **ORCH)
    if warm:
        # the step's key seen once, before the run
        generate(eng, "warm", PROMPT, 4)
    base = eng.decode_plane.captures()
    m = run_serving(eng, mixed_workload(make_workload), 60.0,
                    orchestrator=orch, **CLOCK)
    return eng, orch, m, base


def generate(eng, rid, prompt, max_new):
    """One request to completion through the typed API, then released."""
    h = eng.client.submit(RequestSpec(rid=rid, prompt=prompt,
                                      max_new=max_new))
    while not h.done():
        eng.step()
    eng.release_request(rid)
    return h.tokens()


def events(orch):
    return [(e.t, e.kind, e.worker, e.detail) for e in orch.events]


# --------------------------------------------------------------------------
# the reference's scenario, decision for decision
# --------------------------------------------------------------------------

def test_decisions_streams_and_events_equal_the_reference():
    je, jo, jm = reference_run()
    te, to, tm, _ = port_run()
    assert te.controller.decisions == je.controller.decisions
    assert te.controller.counts == je.controller.counts
    # non-vacuous: every policy acted, and the gate both denied and opened
    for k in ("scale_out", "scale_in", "rebalance", "budget", "preempt",
              "preempt_denied"):
        assert te.controller.counts[k] >= 1, te.controller.counts
    assert tm.outputs == jm.outputs and tm.finished == jm.finished
    assert events(to) == events(jo)
    assert te.placement_generation == je.placement_generation
    assert tm.controller == jm.controller
    np.testing.assert_array_equal(te.placement_mgr.load.ema_ew,
                                  je.placement_mgr.load.ema_ew)


def test_controller_registry_values_equal_the_reference():
    je, _, _ = reference_run()
    te, _, tm, _ = port_run()
    jsnap, tsnap = je.telemetry.snapshot(), te.telemetry.snapshot()
    for part in ("counters", "gauges"):
        want = {k: v for k, v in jsnap[part].items()
                if k.startswith(("controller.", "events.controller_"))}
        got = {k: v for k, v in tsnap[part].items()
               if k.startswith(("controller.", "events.controller_"))}
        assert got == want, part
    assert tsnap["counters"]["controller.decisions.total"] == \
        sum(v for k, v in te.controller.counts.items()
            if k != "preempt_denied") > 0
    for k in {d["kind"] for d in te.controller.decisions}:
        assert tsnap["counters"][f"events.controller_{k}"] == \
            te.controller.counts[k]
    names = {e.get("name") for e in te.telemetry.export_chrome()
             ["traceEvents"]}
    assert any(f"controller_{k}" in names for k in te.controller.counts)
    assert tm.controller["counts"] == te.controller.counts


# --------------------------------------------------------------------------
# inside the port: controller on == its decisions as a script, no new key
# --------------------------------------------------------------------------

def test_controller_on_equals_its_script_with_no_new_capture():
    on, _, m_on, base = port_run("remaining_work", warm=True)
    decisions = on.controller.decisions
    assert any(d["kind"] in ("rebalance", "budget", "scale_out")
               for d in decisions), decisions
    assert on.placement_generation > 0
    assert on.decode_plane.captures() == base

    off = make_engine(**LOOP)
    assert off.controller is None
    # the controller switched the packer to weighted splits at
    # construction; the scripted twin must plan the same
    off.placement_mgr.split_mode = "weighted"
    kind_map = {"scale_out": "add_ew", "scale_in": "drain_ew",
                "rebalance": "rebalance"}
    scales = [ScalePlan(d["t"], kind_map[d["kind"]], d.get("ew", -1))
              for d in decisions if d["kind"] in kind_map]
    budget_script = sorted((d["t"], d["budget"]) for d in decisions
                           if d["kind"] == "budget")
    orig_step = off.step

    def scripted_step(now=None):
        while budget_script and now is not None and \
                now >= budget_script[0][0]:
            off.chunked.set_budget(budget_script.pop(0)[1])
        return orig_step(now=now)

    off.step = scripted_step
    generate(off, "warm", PROMPT, 4)
    m_off = run_serving(off, mixed_workload(make_workload), 60.0,
                        orchestrator=Orchestrator(off, **ORCH),
                        scale_events=scales, **CLOCK)
    assert sorted(m_on.finished) == sorted(m_off.finished)
    assert m_on.outputs == m_off.outputs
    assert off.decode_plane.captures() == base


# --------------------------------------------------------------------------
# hysteresis: an oscillating queue does not flap the pool
# --------------------------------------------------------------------------

def test_autoscale_no_flapping_under_oscillating_queue():
    eng = make_engine(controller="on", max_ew=4, chunk_token_budget=16)
    orch = Orchestrator(eng, **ORCH)
    ctl = eng.controller
    dwell = ctl._scale_dwell()
    assert dwell == 0.4 + 2 * 0.2
    rid = 0
    for i in range(60):
        t = i * 0.05
        if i % 2 == 0:     # burst: well above the scale-out watermark
            for _ in range(8):
                eng.gateway.enqueue(f"h{rid}", PROMPT, 4, now=t)
                rid += 1
        else:              # trough: the queue drains completely
            for q in eng.gateway.queues.values():
                q.clear()
        ctl.tick(t)
        orch.tick(t)
    scale_ts = [d["t"] for d in ctl.decisions
                if d["kind"].startswith("scale")]
    assert ctl.counts["scale_in"] == 0
    assert all(b - a >= dwell - 1e-9
               for a, b in zip(scale_ts, scale_ts[1:])), scale_ts
    assert ctl.counts["scale_out"] >= 1


# --------------------------------------------------------------------------
# deadline-aware preemption: the gate and interactive immunity
# --------------------------------------------------------------------------

def test_preemption_gate_and_interactive_immunity():
    eng = make_engine(controller="on", victim_policy="controller",
                      max_batch=4, ctl_autoscale=False, ctl_rebalance=False)
    for i in range(2):
        eng.client.submit(RequestSpec(rid=f"i{i}", prompt=PROMPT,
                                      max_new=20, slo_class="interactive"))
        eng.client.submit(RequestSpec(rid=f"b{i}", prompt=PROMPT,
                                      max_new=20, slo_class="batch"))
    eng.step(now=0.0)
    assert len(eng.active_requests()) == 4

    # a blocked interactive head with a distant deadline: the gate denies
    eng.client.submit(RequestSpec(rid="late", prompt=PROMPT, max_new=4,
                                  slo_class="interactive", deadline=100.0))
    eng.step(now=0.1)
    assert eng.controller.counts["preempt"] == 0
    assert eng.controller.counts["preempt_denied"] >= 1
    assert eng.gateway.stats.preemptions == 0

    # an imminent deadline opens it: a batch victim goes, interactive
    # residents are never candidates
    eng.gateway.drop("late")
    eng.client.submit(RequestSpec(rid="soon", prompt=PROMPT, max_new=4,
                                  slo_class="interactive", deadline=0.25))
    eng.step(now=0.2)
    assert eng.gateway.stats.preemptions >= 1
    assert eng.controller.counts["preempt"] >= 1
    for i in range(2):
        r = eng.requests[f"i{i}"]
        assert r.preemptions == 0 and not r.queued_for_recovery
    assert any(eng.requests[f"b{i}"].preemptions == 1 or
               eng.requests[f"b{i}"].queued_for_recovery for i in range(2))


def test_victim_pricing_prefers_low_kv_value():
    """Equal remaining work: the victim is the batch request with the
    least resident KV to tear down, as the reference prices it."""
    eng = make_engine(controller="on", victim_policy="controller",
                      max_batch=4, ctl_autoscale=False, ctl_rebalance=False)
    eng.client.submit(RequestSpec(rid="deep", prompt=PROMPT, max_new=24,
                                  slo_class="batch"))
    eng.step(now=0.0)
    for _ in range(8):
        eng.step(now=0.0)
    eng.client.submit(RequestSpec(
        rid="shallow", prompt=PROMPT,
        max_new=24 - len(eng.requests["deep"].tokens), slo_class="batch"))
    eng.step(now=0.1)
    deep, shallow = eng.requests["deep"], eng.requests["shallow"]
    assert eng._remaining_work(deep) == eng._remaining_work(shallow)
    ctl = eng.controller
    # the reference's price: the resident extent (no pages, no prefix hit)
    assert ctl._victim_kv_value(deep) == deep.pos
    assert ctl._victim_kv_value(shallow) == shallow.pos
    assert shallow.pos < deep.pos
    victim = ctl.choose_victim([deep, shallow], head=None, now=0.2)
    assert victim.rid == "shallow"
    assert ctl.decisions[-1]["detail"] == (
        f"victim=shallow remaining={eng._remaining_work(shallow)} "
        f"kv_value={shallow.pos} head=?")


def test_paged_victim_price_counts_exclusive_pages():
    """On a paged engine the price is the victim's exclusive pages (a
    host read of ``PagePool.ref``) times the page size."""
    eng = make_engine(controller="on", victim_policy="controller",
                      max_batch=4, kv_page_tokens=8, chunk_token_budget=8)
    eng.client.submit(RequestSpec(rid="a", prompt=np.arange(1, 20,
                                                            dtype=np.int32),
                                  max_new=8, slo_class="batch"))
    for _ in range(6):
        eng.step(now=0.0)
    r = eng.requests["a"]
    pages = eng.pages.slot_pages(r.slot)
    assert len(pages) >= 2 and all(eng.pages.ref[p] == 1 for p in pages)
    assert eng.controller._victim_kv_value(r) == len(pages) * 8


# --------------------------------------------------------------------------
# weighted split replicas, plan for plan against the reference manager
# --------------------------------------------------------------------------

def test_weighted_splits_equal_the_reference_on_seeded_loads():
    for e, num_ew, seed in ((8, 2, 3), (8, 3, 5), (16, 4, 11)):
        mgrs = []
        for ert_lib, pl in ((tert, tpl), (jert, jpl)):
            mgr = pl.ExpertPlacementManager(
                ert_lib.default_placement(e, num_ew), num_ew)
            mgr.split_mode = "weighted"
            rng = np.random.default_rng(seed)
            heat = rng.zipf(1.5, size=mgr.plan.slot_expert.shape).astype(
                np.float64) * (mgr.plan.slot_expert >= 0)
            for _ in range(6):
                mgr.record_slot_load(heat)
            mgrs.append(mgr)
        got, want = (m.plan_rebalance() for m in mgrs)
        for name in ("slot_expert", "slot_owner", "primary", "split_slot"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name),
                                          err_msg=f"{name} E{e} EW{num_ew}")
        assert (got.generation, got.reason) == (want.generation,
                                                want.reason)
        assert (got.split_slot >= 0).any()
        # and the weighted plan differs from parity's only in its replicas
        par = tpl.ExpertPlacementManager(tert.default_placement(e, num_ew),
                                         num_ew)
        par.load = mgrs[0].load
        assert par.split_mode == "parity"
        np.testing.assert_array_equal(par.plan_rebalance().primary,
                                      got.primary)


def test_parity_split_mode_by_default():
    assert make_engine().placement_mgr.split_mode == "parity"
    assert make_engine(controller="on", max_ew=4).placement_mgr \
        .split_mode == "weighted"


# --------------------------------------------------------------------------
# controller="off" is the default and changes nothing
# --------------------------------------------------------------------------

def test_controller_off_is_default_and_inert():
    eng = make_engine()
    assert eng.ecfg.controller == "off" and eng.controller is None
    assert EngineConfig().controller == JEngineConfig().controller == "off"
    ref = generate(eng, "r", PROMPT, 10)
    on = make_engine(controller="on", ctl_autoscale=False)
    assert generate(on, "r", PROMPT, 10) == ref
    assert on.controller.decisions == []


# --------------------------------------------------------------------------
# both launchers with --controller
# --------------------------------------------------------------------------

def test_launcher_controller_lines_equal_the_reference(monkeypatch):
    """``--controller --workload mixed_slo`` through both launchers, the
    port's engine on the reference launcher's weights: equal decisions,
    orchestrator events and request-plane lines."""
    args = ["--controller", "--workload", "mixed_slo", "--rps", "3",
            "--duration", "1.5"]
    made = []

    class Capture(JEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def lines(text):
        keep = ("requests finished", "request plane", "interactive:",
                "batch:", "standard:", "[orch", "[ctl")
        return [ln.strip() for ln in text.splitlines()
                if ln.strip().startswith(keep)]

    monkeypatch.setattr(jserve, "InferenceEngine", Capture)
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jserve.main()
    want = lines(out.getvalue())

    def port_engine(cfg, ecfg, seed, device):
        return InferenceEngine(cfg, ecfg, params=params_from_reference(
            made[0].params, device=device), device=device)

    monkeypatch.setattr(tserve, "InferenceEngine", port_engine)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--device", "cpu"] + args)
    got = lines(out.getvalue())
    assert got == want
    assert any(ln.startswith("[ctl") for ln in got), got
    assert any("controller_preempt" in ln for ln in got), got


def test_serve_workload_twin_records_a_replayable_incident(tmp_path):
    """The ``serve_workload`` twin with ``--controller``, the watchdogs
    and ``--postmortem`` under an AW failure: the decision and health
    lines print, and the bundle of its run (weights named by seed)
    replays bit for bit on its own."""
    path = str(tmp_path / "pm.json")
    got = []
    m = tserve_workload.main(
        ["--device", "cpu", "--controller", "--workload", "mixed_slo",
         "--rps", "3", "--duration", "2", "--fail-kind", "aw",
         "--fail-at", "0.4", "--watchdogs", "--postmortem", path],
        log=got.append)
    assert any(ln.startswith("  [ctl t=") for ln in got), got
    assert any(ln.startswith("health: 0 watchdog trip(s)") for ln in got)
    assert f"postmortem bundle written to {path} (replay: python -m " \
        f"repro_torch.launch.replay {path} --device cpu)" in got
    bundle = load_bundle(path)
    assert bundle["config"]["weights"] == {"seed": 0}
    assert bundle["outputs"] == m.outputs and m.outputs
    report = replay_bundle(bundle, device="cpu")
    assert report["ok"] and report["matched"] == len(m.outputs)
