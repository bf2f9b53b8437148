"""The port's placement plane (core/placement.py and the engine's plan
installs) against the JAX package's: twins of ``tests/test_placement.py``.

  * ``ExpertPlacementManager``: every plan the port computes equals the
    reference manager's array for array (slot_expert, slot_owner, primary,
    split_slot, candidates, members, generation, reason) over the same call
    sequences and recorded loads, on several geometries, and so do the
    load EMAs, the imbalance and the protect pick;
  * the engine on the reduced Mixtral (capacity factor 4, the reference's
    weights converted): scale-out, rebalance, drain and promotion give the
    reference engine's greedy streams, plan generations, events and load
    EMAs, and the port's own healthy streams where the reference pins
    output invariance; the step's key set (``captures``) stays fixed
    across plan installs;
  * routing: the per-slot dispatch load and the replica split against the
    reference's ``refe.route``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import ert as jert
from repro.core import placement as jpl
from repro.core import refe as jrefe
from repro.core.orchestrator import Orchestrator as JOrch
from repro.serving.api import RequestSpec as JSpec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core import ert as tert
from repro_torch.core import placement as tpl
from repro_torch.core import refe as trefe
from repro_torch.core.orchestrator import Orchestrator as TOrch
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine

PROMPT = np.arange(1, 9, dtype=np.int32)
ENGINE = dict(max_batch=8, max_seq=48, num_aw=2, num_ew=2)


# --------------------------------------------------------------------------
# the manager, array for array
# --------------------------------------------------------------------------

def assert_same_plan(got, want):
    for name in ("slot_expert", "slot_owner", "primary", "split_slot"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_array_equal(got.candidates(), want.candidates())
    assert (got.generation, got.members, got.reason) == \
        (want.generation, want.members, want.reason)


def assert_same_manager(t, j):
    assert_same_plan(t.plan, j.plan)
    assert t.members == j.members
    np.testing.assert_array_equal(t.load.ema_expert, j.load.ema_expert)
    np.testing.assert_array_equal(t.load.ema_ew, j.load.ema_ew)
    assert t.load.total_recorded == j.load.total_recorded
    assert t.imbalance() == j.imbalance()
    assert t.should_rebalance() == j.should_rebalance()
    assert t.can_scale_out() == j.can_scale_out()
    np.testing.assert_array_equal(t.ew_member_mask(), j.ew_member_mask())


def managers(e, num_ew, max_ew=0):
    return [pl.ExpertPlacementManager(ert_lib.default_placement(e, num_ew),
                                      num_ew, max_ew=max_ew)
            for ert_lib, pl in ((tert, tpl), (jert, jpl))]


def skewed_load(num_slots, rng):
    """Dispatch counts with a few hot slots, as a skewed workload gives."""
    load = rng.integers(0, 4, size=num_slots).astype(np.float64)
    load[rng.choice(num_slots, size=max(1, num_slots // 5),
                    replace=False)] += 60.0
    return load


# each sequence: calls made on both managers, loads recorded in between
SEQUENCES = {
    "scale_out_in": [("load", 8), ("scale_out",), ("load", 4),
                     ("rebalance",), ("scale_out",), ("scale_in", 0),
                     ("load", 4), ("protect", ())],
    "promote_reprotect": [("load", 12), ("promote", 0), ("protect", ()),
                          ("reprotect_pick", ()), ("load", 6),
                          ("rebalance",)],
    "revival": [("load", 10), ("rebalance_live", (1, 2, 3)),
                ("reprotect", 2, (1,)), ("reprotect", 1, (0,)),
                ("protect", (1,))],
    "adopt": [("adopt",), ("load", 5), ("rebalance",),
              ("reprotect", 0, ())],
}


def run_sequence(mgr, seq, seed):
    rng = np.random.default_rng(seed)
    out = []
    for step in seq:
        try:
            out += run_step(mgr, step, rng)
        except ValueError as e:      # a refusal must be the reference's
            out.append(("refused", str(e)))
    return out


def run_step(mgr, step, rng):
    """One call of a sequence; returns what it yields to compare."""
    kind, args = step[0], step[1:]
    if kind == "load":
        for _ in range(args[0]):
            mgr.record_slot_load(skewed_load(mgr.plan.num_slots, rng))
        return [mgr.plan]
    if kind == "protect":
        return [mgr.choose_protect_ew(args[0])]
    if kind == "scale_out":
        return list(mgr.plan_scale_out())
    if kind == "scale_in":
        return [mgr.plan_scale_in(mgr.members[args[0]])]
    if kind == "rebalance":
        return [mgr.plan_rebalance()]
    if kind == "rebalance_live":
        return [mgr.plan_rebalance(live=tuple(m for m in args[0]
                                              if m in mgr.members))]
    if kind == "promote":
        return [mgr.promote_shadows(mgr.members[args[0]])]
    if kind == "reprotect":
        return [mgr.plan_reprotect(args[0] % len(mgr.members),
                                   dead_ews=args[1])]
    if kind == "reprotect_pick":
        return [mgr.plan_reprotect(mgr.choose_protect_ew(args[0]))]
    assert kind == "adopt"
    return [mgr.adopt(np.roll(mgr.plan.slot_expert, 1), reason="rolled")]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("geom", [(8, 2, 4), (8, 4, 5), (16, 4, 6),
                                  (6, 3, 4), (60, 4, 6)])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_manager_plans_match_reference(name, geom, seed):
    t, j = managers(*geom)
    assert_same_manager(t, j)
    seq = SEQUENCES[name]
    if name == "promote_reprotect" and geom[1] == 2:
        seq = seq[:3]              # a pool of one cannot re-pack
    got, want = run_sequence(t, seq, seed), run_sequence(j, seq, seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, jpl.PlacementPlan):
            assert_same_plan(a, b)
        else:
            assert a == b
    assert_same_manager(t, j)
    assert len(t.history) == len(j.history)


def test_manager_refusals_match_reference():
    t, j = managers(8, 2)
    for m in (t, j):
        with pytest.raises(ValueError, match="max_ew"):
            m.plan_scale_out()
        with pytest.raises(ValueError, match="not a pool member"):
            m.plan_scale_in(3)
        m.plan_scale_in(1)
        with pytest.raises(ValueError, match="last EW"):
            m.plan_scale_in(0)
    assert_same_manager(t, j)


def test_rebalance_spreads_skewed_load():
    """The reference's skew case: four hot experts primaried on EW0 end on
    four EWs, and the most loaded EW is the protect pick."""
    t, j = managers(16, 4)
    load = np.zeros((t.plan.num_slots,))
    load[0:4] = 100.0
    load[4:16] = 1.0
    for m in (t, j):
        for _ in range(20):
            m.record_slot_load(load)
    assert t.imbalance() > 2.0 and t.should_rebalance()
    plan = t.plan_rebalance()
    assert_same_plan(plan, j.plan_rebalance())
    assert len({int(plan.slot_owner[plan.primary[e]])
                for e in range(4)}) == 4
    assert t.choose_protect_ew() == j.choose_protect_ew() == 0


# --------------------------------------------------------------------------
# routing: the dispatch-load counter and the replica split
# --------------------------------------------------------------------------

def _route_both(e, t, logits, split=None, health=None, capacity=None):
    out = []
    for ert_lib, refe_lib in ((tert, trefe), (jert, jrefe)):
        p = ert_lib.default_placement(e, 2)
        if refe_lib is trefe:
            rs = trefe.RouteState.healthy(p, 1, device="cpu")
            if split is not None:
                rs = rs._replace(split_slot=torch.as_tensor(split))
            if health is not None:
                rs = rs._replace(ew_health=torch.as_tensor(health))
            x = torch.zeros((t, 8))
            lg = torch.as_tensor(logits)
        else:
            rs = jrefe.RouteState.healthy(p, num_aw=1)
            if split is not None:
                rs = rs._replace(split_slot=jrefe.jnp.asarray(split))
            if health is not None:
                rs = rs._replace(ew_health=jrefe.jnp.asarray(health))
            x = jrefe.jnp.zeros((t, 8))
            lg = jrefe.jnp.asarray(logits)
        r = refe_lib.route(x, lg, rs, p, top_k=1 if split is not None
                           else 2, capacity_factor=4.0, capacity=capacity,
                           batch=t)
        out.append({k: np.asarray(r[k]) for k in ("slot_load", "slot_idx",
                                                  "keep")})
    return out


def test_dispatch_load_counter_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((12, 4)).astype(np.float32)
    got, want = _route_both(4, 12, logits)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        got["slot_load"],
        np.bincount(got["slot_idx"].reshape(-1),
                    weights=got["keep"].reshape(-1),
                    minlength=got["slot_load"].shape[0]))


def test_split_slot_halves_expert_traffic_as_reference():
    e, t = 4, 16
    cand = tert.build_candidates(tert.default_placement(e, 2),
                                 tert.initial_shadow_assignment(
                                     tert.default_placement(e, 2)))
    target = next(ex for ex in range(e) if cand[ex, 1] >= 0)
    split = np.full((e,), -1, np.int32)
    split[target] = cand[target, 1]
    logits = np.full((t, e), -10.0, np.float32)
    logits[:, target] = 10.0
    got, want = _route_both(e, t, logits, split=split, capacity=t)
    np.testing.assert_array_equal(got["slot_load"], want["slot_load"])
    assert got["slot_load"][cand[target, 0]] == t // 2
    assert got["slot_load"][cand[target, 1]] == t // 2
    # the replica's EW dies: every token falls back to the primary
    got, want = _route_both(e, t, logits, split=split, capacity=t,
                            health=np.array([True, False]))
    np.testing.assert_array_equal(got["slot_load"], want["slot_load"])
    assert got["slot_load"][cand[target, 0]] == t


# --------------------------------------------------------------------------
# the engine: streams, generations, events and EMAs against the reference
# --------------------------------------------------------------------------

def _cfg(get_config, num_experts):
    cfg = get_config("mixtral_8x7b").reduced()
    moe = dataclasses.replace(cfg.moe, capacity_factor=4.0)
    if num_experts:
        moe = dataclasses.replace(moe, num_experts=num_experts)
    return dataclasses.replace(cfg, moe=moe)


@functools.lru_cache(maxsize=None)
def _params(num_experts):
    je = _jax_engine(num_experts)
    return params_from_reference(je.params, device="cpu")


def _jax_engine(num_experts=0, **kw):
    return JEngine(_cfg(jget_config, num_experts), JEngineConfig(
        **ENGINE, telemetry=False, flight_recorder=False, **kw),
        jax.random.PRNGKey(7))


def _port_engine(num_experts=0, **kw):
    return InferenceEngine(_cfg(tget_config, num_experts),
                           EngineConfig(**ENGINE, **kw),
                           params=_params(num_experts), device="cpu")


def _submit(eng, rid, max_new):
    spec = JSpec if isinstance(eng, JEngine) else RequestSpec
    return eng.client.submit(spec(rid=rid, prompt=PROMPT, max_new=max_new))


def _finish(eng, h):
    while not h.done():
        eng.step()
    return h.tokens()


@functools.lru_cache(maxsize=None)
def _healthy(num_experts, max_new):
    """The port's failure-free, plan-free stream."""
    eng = _port_engine(num_experts)
    return _finish(eng, _submit(eng, "r", max_new))


def _elastic(eng):
    """The reference's no-retrace sequence: scale-out, rebalance, drain,
    promotion and re-protection, a step after each. Returns the stream, the
    plans in order, the plan events and the manager after each install."""
    h = _submit(eng, "r", 20)
    eng.step()
    new = eng.add_ew(now=1.0)
    eng.step()
    eng.rebalance(now=2.0)
    eng.step()
    eng.drain_ew(new, now=3.0)
    eng.step()
    # the rebalance and drain were output-exact: so far the healthy stream
    head = list(h.tokens())
    eng.fail_ew(0)
    eng.promote_shadows(0, now=4.0)
    eng.step()
    eng.repoint_shadows(1, now=5.0)
    eng.step()
    toks = _finish(eng, h)
    mgr = eng.placement_mgr
    return dict(tokens=toks, head=head, plans=list(mgr.history), mgr=mgr,
                events=[(e.t, e.kind, e.worker, e.detail)
                        for e in eng.drain_plan_events()],
                live=sorted(eng.live_ews),
                generation=eng.placement_generation)


@pytest.fixture(scope="module")
def elastic():
    return _elastic(_jax_engine(16, max_ew=4)), \
        _elastic(_port_engine(16, max_ew=4))


def test_elastic_sequence_matches_reference(elastic):
    want, got = elastic
    assert got["tokens"] == want["tokens"]
    assert got["generation"] == want["generation"] == 5
    assert got["events"] == want["events"]
    assert [e[1] for e in got["events"]] == ["placement_changed"] * 5
    assert got["live"] == want["live"] == [1]
    assert len(got["plans"]) == len(want["plans"])
    for a, b in zip(got["plans"], want["plans"]):
        assert_same_plan(a, b)
    assert_same_manager(got["mgr"], want["mgr"])


def test_scale_out_rebalance_and_drain_are_output_invariant(elastic):
    """Replica slots serve identical weights and split traffic by parity:
    up to the promotion (which parks experts without a live replica) the
    stream is the port's healthy one."""
    _, got = elastic
    healthy = _healthy(16, 20)
    assert got["head"] == healthy[:len(got["head"])]
    assert len(got["head"]) == 4


def test_placement_changes_add_no_step_keys():
    eng = _port_engine(16, max_ew=4)
    h = _submit(eng, "r", 30)
    eng.step()
    keys = eng.decode_plane.captures()
    shapes = [tuple(t.shape) for t in eng.route_state]
    new = eng.add_ew(now=1.0)
    eng.rebalance(now=2.0)
    eng.step()
    eng.drain_ew(new, now=3.0)
    eng.fail_ew(0)
    eng.promote_shadows(0, now=4.0)
    eng.step()
    assert eng.decode_plane.captures() == keys
    assert [tuple(t.shape) for t in eng.route_state] == shapes
    assert [tuple(t.shape) for t in eng.decode_plane.route_state] == shapes
    assert not h.done()


@pytest.mark.parametrize("change", ["rebalance", "add_ew"])
def test_mid_stream_plan_change_is_output_invariant(change):
    """A rebalance or a scale-out after 5 steps leaves the stream the
    healthy run's (the elastic sequence holds both to the reference)."""
    eng = _port_engine(16, max_ew=3)
    h = _submit(eng, "r", 16)
    for _ in range(5):
        eng.step()
    plan = getattr(eng, change)(now=1.0)
    if change == "rebalance":
        assert plan.generation == 1 and plan.split_slot.max() >= 0
    assert _finish(eng, h) == _healthy(16, 16)


def test_rebalance_during_revival_avoids_dead_member():
    out = []
    for eng in (_jax_engine(), _port_engine()):
        h = _submit(eng, "r0", 20)
        for _ in range(4):
            eng.step()
        eng.fail_ew(0)                # revive policy: still a member
        plan = eng.rebalance(now=1.0)
        assert all(plan.slot_owner[plan.primary[e]] == 1
                   for e in range(eng.api.placement.num_experts))
        out.append((_finish(eng, h), plan))
    assert out[1][0] == out[0][0] == _healthy(0, 20)
    assert_same_plan(out[1][1], out[0][1])


def _promote(eng, orch_cls):
    orch = orch_cls(eng, worker_init_time=1.0, weight_push_time=0.2,
                    ew_policy="promote")
    h = _submit(eng, "r0", 14)
    for _ in range(4):
        eng.step()
    orch.inject_failure("ew", 0, now=1.0)
    fired = orch.tick(1.0 + orch.detection_latency() + 1e-6)
    assert any(e.kind == "detected" and "promoted" in e.detail
               for e in fired)
    assert eng.live_ews == {1}
    toks = _finish(eng, h)
    fired = orch.tick(1.0 + orch.detection_latency() + 0.2 + 1e-6)
    assert any(e.kind == "reprotected" for e in fired)
    assert any(e.kind == "placement_changed" for e in fired)
    return toks, [(e.t, e.kind, e.worker, e.detail) for e in orch.events], \
        eng.placement_mgr


def test_promotion_is_exact_for_covered_experts():
    """EW0 fails under the promote policy: its shadows become primaries
    and the pool shrinks; the stream is the failure-free one, and the
    events and plans are the reference's."""
    jt, jev, jm = _promote(_jax_engine(), JOrch)
    tt, tev, tm = _promote(_port_engine(), TOrch)
    assert tt == jt == _healthy(0, 14)
    assert tev == jev
    assert_same_manager(tm, jm)


def test_engine_drains_load_counters_into_ema():
    """Prefill and decode loads reach the manager as the reference's do:
    the same EMAs after the same steps, attributed to the owning EWs."""
    mgrs = []
    for eng in (_jax_engine(), _port_engine()):
        _submit(eng, "r0", 8)
        for _ in range(6):
            eng.step()
        mgrs.append(eng.placement_mgr)
    jm, tm = mgrs
    assert tm.load.total_recorded > 0 and tm.load.ema_expert.sum() > 0
    assert sum(tm.per_ew_load().values()) > 0
    assert_same_manager(tm, jm)
    assert tm.per_ew_load() == jm.per_ew_load()


def test_orchestrator_emits_placement_events():
    evs = []
    for eng, orch_cls in ((_jax_engine(max_ew=3), JOrch),
                          (_port_engine(max_ew=3), TOrch)):
        orch = orch_cls(eng, worker_init_time=0.1, weight_push_time=0.1)
        _submit(eng, "r0", 30)
        eng.step()
        orch.request_scale_out(now=0.0)
        fired = orch.tick(0.25)
        kinds = [e.kind for e in fired]
        assert "scaled_out" in kinds and "placement_changed" in kinds
        gen_ev = next(e for e in fired if e.kind == "placement_changed")
        assert gen_ev.worker == "gen1"
        evs.append([(e.t, e.kind, e.worker, e.detail) for e in orch.events])
    assert evs[1] == evs[0]


def test_slot_view_and_expert_worker_retire_match_reference():
    """``ClusterSlotView``'s partition width and ``retire`` (a drained or
    promoted-away EW becomes a spare) as in the reference."""
    from repro.core.checkpoint import CheckpointStore as JStore
    from repro.serving import workers as jw
    from repro_torch.core.checkpoint import CheckpointStore as TStore
    from repro_torch.serving import workers as tw
    out = []
    for w, store, route in ((jw, JStore(), jrefe.RouteState.healthy(
            jert.default_placement(8, 3), 2)),
                            (tw, TStore(), trefe.RouteState.healthy(
            tert.default_placement(8, 3), 2, device="cpu"))):
        aws = [w.AttentionWorker(a, a * 4, (a + 1) * 4, store)
               for a in range(2)]
        got = [w.ClusterSlotView(aws, 8).per_aw]
        ew = w.ExpertWorker(2)
        route = ew.retire(route)
        got += [ew.alive, ew.member, np.asarray(route.ew_health).tolist()]
        route = ew.provision(route)
        got += [ew.alive, ew.member, np.asarray(route.ew_health).tolist()]
        out.append(got)
    assert out[1] == out[0]
    assert out[1][:3] == [4, False, False]
