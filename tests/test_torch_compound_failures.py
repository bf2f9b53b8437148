"""Overlapping failures in the port against the JAX package: twins of
``tests/test_compound_failures.py`` (its mixed-class case is in
``tests/test_torch_preemption.py``), of the serving cases of
``tests/test_integration_extras.py`` (its weight-checkpoint round trip is
in ``tests/test_torch_train_twins.py``) and of
``tests/test_recovery_under_load.py``.

Each scenario runs on both packages: the reduced Mixtral at capacity
factor 4.0 (no call drops a token), the port with the reference's
weights, converted. Each asserts that

  * the port's greedy streams equal the JAX engine's;
  * the port's streams equal the port's own failure-free run of the same
    requests on a fresh engine, bit for bit;
  * the orchestrator's events ``(t, kind, worker, detail)`` and the
    checkpoint store's counters equal the reference's.

Every scenario fails a worker, so each side gets a fresh engine (the
reference's compiled functions are shared across its engines in one
process; an engine after the first costs little).
"""
import dataclasses
import functools

import jax
import numpy as np

from repro.configs import get_config as jget_config
from repro.core import selfheal as jselfheal
from repro.core.orchestrator import Orchestrator as JOrch
from repro.data.workloads import make_workload as jmake_workload
from repro.models import get_model as jget_model
from repro.serving.api import RequestSpec as JSpec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.scheduler import FailurePlan as JFailurePlan
from repro.serving.scheduler import run_serving as jrun_serving
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core import selfheal as tselfheal
from repro_torch.core.orchestrator import Orchestrator as TOrch
from repro_torch.data.workloads import make_workload
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.scheduler import FailurePlan, run_serving

PROMPT_A = np.arange(1, 9, dtype=np.int32)
PROMPT_B = np.arange(2, 10, dtype=np.int32)
COMPOUND = dict(max_batch=8, max_seq=48, num_aw=2, num_ew=2)   # key 7
EXTRAS = dict(max_batch=8, max_seq=64, num_aw=2, num_ew=2)     # key 7


def _cfg(get_config, num_shadow=None):
    cfg = get_config("mixtral_8x7b").reduced()
    moe = dataclasses.replace(cfg.moe, capacity_factor=4.0)
    if num_shadow is not None:
        moe = dataclasses.replace(moe, num_shadow_slots=num_shadow)
    return dataclasses.replace(cfg, moe=moe)


@functools.lru_cache(maxsize=None)
def _params(key: int):
    """The reference engine's weights for PRNG key ``key``, converted
    (the bank holds one row per expert, so they fit every EW count)."""
    return params_from_reference(
        jget_model(_cfg(jget_config)).init_params(jax.random.PRNGKey(key)),
        device="cpu")


class Side:
    """One package's fresh engine behind one interface."""

    def __init__(self, pkg, key=7, num_shadow=None, **kw):
        self.pkg = pkg
        self.spec = JSpec if pkg == "jax" else RequestSpec
        self.orch_cls = JOrch if pkg == "jax" else TOrch
        self.selfheal = jselfheal if pkg == "jax" else tselfheal
        if pkg == "jax":
            self.eng = JEngine(_cfg(jget_config, num_shadow), JEngineConfig(
                **kw, telemetry=False, flight_recorder=False),
                jax.random.PRNGKey(key))
        else:
            self.eng = InferenceEngine(_cfg(tget_config, num_shadow),
                                       EngineConfig(**kw),
                                       params=_params(key), device="cpu")

    def submit(self, rid, prompt, max_new, now=0.0):
        return self.eng.client.submit(self.spec(rid=rid, prompt=prompt,
                                                max_new=max_new), now=now)

    def stats(self):
        return dataclasses.asdict(self.eng.store.stats)


def events(orch):
    return [(e.t, e.kind, e.worker, e.detail) for e in orch.events]


def both(scenario, **kw):
    """``scenario(side)`` on a fresh engine of each package; returns
    (jax, port)."""
    return [scenario(Side(pkg, **kw)) for pkg in ("jax", "port")]


def failure_free(prompts, max_new, make=None, **kw):
    """The port's streams of ``prompts`` submitted together on a fresh
    engine with no failure (``generate`` for one prompt, as the
    reference's tests take theirs)."""
    side = Side("port", **kw)
    if make is not None:
        make(side)
    if len(prompts) == 1:
        return side.eng.generate("ref", prompts[0], max_new)
    hs = [side.submit(f"ref{i}", p, max_new) for i, p in enumerate(prompts)]
    while not all(h.done() for h in hs):
        side.eng.step()
    return [h.tokens() for h in hs]


# --------------------------------------------------------------------------
# tests/test_compound_failures.py
# --------------------------------------------------------------------------

def _dual_protect(side):
    """The reference's 3-EW layout: every expert of EW0 and EW1 has its
    failover replica on EW2 (4 experts, 6 shadow slots: EW2 owns primary
    pads 4, 5 and shadows 8, 11)."""
    eng = side.eng
    p = eng.api.placement
    assert p.primary_slots == 6 and p.num_slots == 12
    owner = p.slot_owner()
    ew2 = [s for s in range(p.num_slots) if owner[s] == 2]
    assert len(ew2) == 4
    slot_expert = np.full((p.num_slots,), -1, np.int32)
    slot_expert[:4] = np.arange(4)
    for ex, s in enumerate(ew2):
        slot_expert[s] = ex
    plan = eng.placement_mgr.adopt(slot_expert, reason="dual protect ew0+ew1")
    eng.install_plan(plan)
    cand = plan.candidates()
    assert all(cand[e, 1] >= 0 and owner[cand[e, 1]] == 2 for e in range(4))


DUAL = dict(COMPOUND, num_ew=3, num_shadow=6)


def test_ew_dies_while_other_ew_mid_provision():
    """EW0 fails; while its replacement provisions (T_w), EW1 fails too.
    Both EWs' experts have replicas on EW2: every token equals the
    failure-free run, and re-pointing while EW1 is down keeps its
    replicas pinned (plan_reprotect's dead_ews)."""
    def scenario(s):
        _dual_protect(s)
        eng = s.eng
        orch = s.orch_cls(eng, worker_init_time=1.0, weight_push_time=0.2)
        s.submit("a", PROMPT_A, 16)
        s.submit("b", PROMPT_B, 16)
        for _ in range(4):
            eng.step()
        orch.inject_failure("ew", 0, now=10.0)
        fired = orch.tick(10.0 + orch.detection_latency() + 1e-6)
        assert any(e.kind == "detected" for e in fired)
        assert eng.failed_ews == {0}
        for _ in range(3):
            eng.step()
        orch.inject_failure("ew", 1, now=10.5)
        fired = orch.tick(10.5 + orch.detection_latency() + 1e-6)
        assert any(e.kind == "detected" for e in fired)
        assert eng.failed_ews == {0, 1}
        while eng.active_requests():
            eng.step()
        toks = [eng.requests[r].tokens for r in ("a", "b")]
        orch.tick(11.2)
        assert eng.failed_ews == {1}
        assert s.selfheal.experts_without_healthy_replica(
            eng.route_state, eng.api.placement).size == 0
        orch.tick(11.8)
        assert eng.failed_ews == set() and orch.outstanding == 0
        return toks, events(orch), s.stats(), eng.placement_generation
    (jt, jev, jst, jg), (tt, tev, tst, tg) = both(scenario, **DUAL)
    assert tt == jt and tev == jev and tst == jst and tg == jg
    assert tt == failure_free([PROMPT_A, PROMPT_B], 16, _dual_protect,
                              **DUAL)


def test_aw_and_ew_die_in_same_detection_window():
    """AW0 and EW0 fail in one detection window: the per-request restore
    onto AW1 composes with the shadow failover."""
    def scenario(s):
        eng = s.eng
        orch = s.orch_cls(eng, worker_init_time=1.0)
        s.submit("a", PROMPT_A, 14)
        s.submit("b", PROMPT_B, 14)
        for _ in range(4):
            eng.step()
        assert eng.requests["a"].aw == 0 and eng.requests["b"].aw == 1
        orch.inject_failure("aw", 0, now=5.0)
        orch.inject_failure("ew", 0, now=5.0)
        fired = orch.tick(5.0 + orch.detection_latency() + 1e-6)
        assert sorted(e.kind for e in fired) == ["detected", "detected"]
        assert eng.failed_aws == {0} and eng.failed_ews == {0}
        assert eng.requests["a"].aw == 1
        while eng.active_requests():
            eng.step()
        toks = [eng.requests[r].tokens for r in ("a", "b")]
        assert eng.store.stats.restores == 1
        orch.tick(7.0)
        assert eng.failed_aws == set() and eng.failed_ews == set()
        assert orch.outstanding == 0
        return toks, events(orch), s.stats()
    (jt, jev, jst), (tt, tev, tst) = both(scenario, **COMPOUND)
    assert tt == jt and tev == jev and tst == jst
    assert tt == failure_free([PROMPT_A, PROMPT_B], 14, **COMPOUND)


CHUNKED = dict(COMPOUND, chunk_token_budget=8, prefill_bucket=16, max_seq=64)


def test_compound_failure_during_chunked_prefill():
    """AW dies mid chunked prefill and an EW in the same window: the
    stream resumes from its committed cursor on the healthy AW."""
    long_prompt = np.arange(1, 33, dtype=np.int32)

    def scenario(s):
        eng = s.eng
        orch = s.orch_cls(eng, worker_init_time=1.0)
        s.submit("r", long_prompt, 10)
        eng.step()
        r = eng.requests["r"]
        assert r.prefilling and r.prefill_cursor > 0
        cursor = r.prefill_cursor
        orch.inject_failure("aw", r.aw, now=3.0)
        orch.inject_failure("ew", 0, now=3.0)
        orch.tick(3.0 + orch.detection_latency() + 1e-6)
        while not eng.requests["r"].done:
            eng.step()
        st = eng.chunked.stats
        assert st.resumed == 1
        return (eng.requests["r"].tokens, events(orch), s.stats(), cursor,
                st.restored_tokens, st.prefilled_tokens)
    j, t = both(scenario, **CHUNKED)
    assert t == j
    assert t[0] == failure_free([long_prompt], 10, **CHUNKED)


def test_cancel_during_aw_recovery_loses_no_other_request():
    """AW0 dies holding a and c; AW1 has one free slot, so one is
    restored and one waits. Cancelling a inside the recovery window
    leaves no stale entry, leaks no slot or log, and b and c finish
    bitwise."""
    kw = dict(COMPOUND, max_batch=4)

    def scenario(s):
        eng = s.eng
        orch = s.orch_cls(eng, worker_init_time=1.0)
        ha = s.submit("a", PROMPT_A, 14)
        hb = s.submit("b", PROMPT_B, 14)
        hc = s.submit("c", PROMPT_A + 1, 14)
        assert eng.requests["a"].aw == 0 and eng.requests["c"].aw == 0
        assert eng.requests["b"].aw == 1
        for _ in range(4):
            eng.step()
        orch.inject_failure("aw", 0, now=5.0)
        orch.tick(5.0 + orch.detection_latency() + 1e-6)
        assert eng.gateway.depth() == 1
        assert ha.cancel(now=5.1)
        assert ha.state() == "cancelled"
        assert eng.gateway.find("a") is None and "a" not in eng.requests
        while not (hb.done() and hc.done()):
            eng.step()
        orch.tick(7.0)
        eng.release_request("b")
        eng.release_request("c")
        assert sum(w.slots.free_count() for w in eng.aws) == 4
        assert not eng.store.active_requests_on(0)
        return ([hb.tokens(), hc.tokens()], events(orch), s.stats(),
                [(e.t, e.kind, e.worker, e.detail) for e in eng.request_log])
    j, t = both(scenario, **kw)
    assert t == j
    assert t[0] == failure_free([PROMPT_B, PROMPT_A + 1], 14, **kw)


# --------------------------------------------------------------------------
# tests/test_integration_extras.py
# --------------------------------------------------------------------------

def test_cascading_ew_then_aw_failure_exact():
    def scenario(s):
        eng = s.eng
        s.submit("r", PROMPT_A, 16)
        for _ in range(3):
            eng.step()
        eng.fail_ew(0)
        for _ in range(3):
            eng.step()
        eng.fail_aw(0)
        assert eng.recover_aw_requests() == ["r"]
        while not eng.requests["r"].done:
            eng.step()
        return eng.requests["r"].tokens, s.stats()
    j, t = both(scenario, **EXTRAS)
    assert t == j
    assert t[0] == failure_free([PROMPT_A], 16, **EXTRAS)


def test_failover_then_provision_then_fail_again():
    """EW0 fails, is provisioned back with the shadows re-pointed to EW1,
    then EW1 fails: the whole lifecycle of section 5.4."""
    def scenario(s):
        eng = s.eng
        s.submit("r", PROMPT_A, 16)
        for _ in range(3):
            eng.step()
        eng.fail_ew(0)
        for _ in range(3):
            eng.step()
        eng.provision_ew(0, repoint_protect=1)
        for _ in range(3):
            eng.step()
        eng.fail_ew(1)
        while not eng.requests["r"].done:
            eng.step()
        return (eng.requests["r"].tokens, eng.placement_generation,
                eng.placement_mgr.plan.candidates().tolist())
    j, t = both(scenario, **EXTRAS)
    assert t == j
    assert t[0] == failure_free([PROMPT_A], 16, **EXTRAS)


def test_aw_failure_with_no_spare_capacity_waits():
    """With no healthy AW slot free, recovery defers instead of failing,
    and the other requests keep decoding."""
    def scenario(s):
        eng = s.eng
        for i in range(4):
            s.submit(f"f{i}", PROMPT_A + i, 30)
        s.submit("victim", PROMPT_A, 30)
        victim_aw = eng.requests["victim"].aw
        eng.fail_aw(victim_aw)
        recovered = eng.recover_aw_requests()
        others = [r.rid for r in eng.requests.values() if r.aw != victim_aw]
        full = all(eng.slots.free_count(a) == 0
                   for a in range(2) if a != victim_aw)
        if full:
            assert "victim" not in recovered
        out = eng.step()
        assert any(rid in out for rid in others)
        return (victim_aw, recovered, full, sorted(others),
                {rid: list(v) for rid, v in out.items()}, s.stats())
    j, t = both(scenario, **EXTRAS)
    assert t == j


def test_moe_decode_survives_total_expert_loss_on_one_layer():
    """EW1 fails with no shadow of its experts (the shadows protect EW0):
    the router renormalises over the reachable experts and decoding goes
    on, token for token as the reference's."""
    def scenario(s):
        eng = s.eng
        s.submit("r", PROMPT_A, 10)
        eng.fail_ew(1)
        lost = s.selfheal.experts_without_healthy_replica(
            eng.route_state, eng.api.placement).tolist()
        while not eng.requests["r"].done:
            eng.step()
        return eng.requests["r"].tokens, lost
    (jt, jlost), (tt, tlost) = both(scenario, **EXTRAS)
    assert tlost == jlost and len(tlost) > 0
    assert tt == jt and len(tt) == 10
    assert all(0 <= x < _cfg(tget_config).vocab_size for x in tt)


# --------------------------------------------------------------------------
# tests/test_recovery_under_load.py: an AW fails while 12 requests wait
# behind 8 slots
# --------------------------------------------------------------------------

N_REQ = 12
STEP = 0.05


def _workload(make):
    wl = make("random", rate_rps=4.0, duration=3.0, seed=6)
    wl = [dataclasses.replace(w, arrival=0.0, prompt_len=6 + (i % 5),
                              max_new_tokens=10)
          for i, w in enumerate(wl)]
    assert len(wl) >= N_REQ
    return wl[:N_REQ]


def _serve(pkg, fail: bool):
    side = Side(pkg, key=1, **EXTRAS)
    orch = side.orch_cls(side.eng, worker_init_time=0.6)
    if pkg == "jax":
        plans = [JFailurePlan(0.12, "aw", 0)] if fail else []
        m = jrun_serving(side.eng, _workload(jmake_workload), duration=200.0,
                         orchestrator=orch, failures=plans, step_time=STEP)
    else:
        plans = [FailurePlan(0.12, "aw", 0)] if fail else []
        m = run_serving(side.eng, _workload(make_workload), duration=200.0,
                        orchestrator=orch, failures=plans, step_time=STEP)
    return side, orch, m


@functools.lru_cache(maxsize=None)
def _under_load():
    """(jax, port) runs with ``aw:0@0.12``, and the port's failure-free
    run."""
    return _serve("jax", True), _serve("port", True), _serve("port", False)


def _digest(side, orch, m):
    gw = side.eng.gateway.stats
    return dict(outputs=m.outputs, finished=m.finished,
                queue_delay=m.queue_delay, ttft=m.ttft,
                token_log=[(r.t, r.rid) for r in m.token_log],
                events=events(orch), store=side.stats(),
                requeued=gw.requeued, admitted=gw.admitted)


def test_aw_failure_while_queued_loses_nothing():
    (js, jo, jm), (ts, to, tm), (_, _, ref) = _under_load()
    assert _digest(ts, to, tm) == _digest(js, jo, jm)
    assert len(ref.finished) == len(tm.finished) == N_REQ
    assert ts.eng.gateway.depth() == 0
    t_detect = next(e.t for e in to.events if e.kind == "detected")
    t_prov = next(e.t for e in to.events if e.kind == "provisioned")
    assert ts.eng.store.stats.restores >= 1
    assert ts.eng.gateway.stats.requeued >= 1
    # the healthy AW keeps decoding through the outage
    assert any(t_detect < r.t <= t_prov for r in tm.token_log)
    # every stream is the failure-free run's, bit for bit
    assert tm.outputs == ref.outputs


def test_queued_requests_admitted_after_recovery_on_healthy_aw():
    _, (ts, _, tm), _ = _under_load()
    assert tm.queue_delay and max(tm.queue_delay_values()) > 0.0
    assert not ts.eng.requests
    assert sum(w.slots.free_count() for w in ts.eng.aws) == 8
    # nothing is left pending for a released request
    ck = ts.eng.checkpointers
    assert sorted(ck) == [0, 1] and [c.aw_id for c in ck.values()] == [0, 1]
    assert all(c.pending_for(rid) == 0 for c in ck.values()
               for rid in tm.outputs)

