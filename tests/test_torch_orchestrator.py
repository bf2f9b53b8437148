"""The port's control plane against the JAX package's: twins of
``tests/test_failover.py``'s orchestrator, shadow re-pointing and baseline
tests on the reduced Mixtral at capacity factor 4.0, each run on both
packages (the port with the reference's weights, converted) with equal
streams and equal orchestrator events ``(t, kind, worker, detail)``; the
``selfheal`` additions against the reference's functions; and the
``session_affinity`` policy's placements and re-pins against the JAX
gateway.

Both engines keep a placement manager: each re-points the shadows to its
manager's pick of the most loaded EW, and the events compared include the
``placement_changed`` event of each plan install. The elastic entry
points (scale-out, drain, rebalance) run on both packages with equal
events, plan generations and streams."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced
from repro.core import ert as jert
from repro.core import selfheal as jsh
from repro.core.orchestrator import Orchestrator as JOrch
from repro.core.refe import RouteState as JRoute
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core import ert as tert
from repro_torch.core import placement as tpl
from repro_torch.core import selfheal as tsh
from repro_torch.core import shadow as tshadow
from repro_torch.core.orchestrator import Orchestrator as TOrch
from repro_torch.core.refe import RouteState as TRoute
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine

PROMPT = np.arange(1, 9, dtype=np.int32)
BASE = dict(max_batch=8, max_seq=48, num_aw=2, num_ew=2)


@pytest.fixture(scope="module")
def weights():
    """The reference engine's weights, and the port's conversion."""
    je = _jax_engine()
    return je.params, params_from_reference(je.params, device="cpu")


def _jax_engine(**kw):
    return JEngine(
        reduced("mixtral_8x7b", cap_factor=4.0),
        JEngineConfig(**BASE, telemetry=False, flight_recorder=False, **kw),
        jax.random.PRNGKey(7))


def _port_engine(params, **kw):
    cfg = tget_config("mixtral_8x7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    return InferenceEngine(cfg, EngineConfig(**BASE, **kw), params=params,
                           device="cpu")


class Side:
    """One package's engine and orchestrator behind one interface."""

    def __init__(self, pkg, weights, worker_init_time=None, **kw):
        self.pkg = pkg
        if pkg == "jax":
            self.eng = _jax_engine(**kw)
            self.eng.params = weights[0]
            orch = JOrch
        else:
            self.eng = _port_engine(weights[1], **kw)
            orch = TOrch
        self.orch = None if worker_init_time is None else \
            orch(self.eng, worker_init_time=worker_init_time)

    def submit(self, rid, prompt, max_new):
        if self.pkg == "jax":
            assert self.eng._submit_sync(rid, prompt, max_new)
        else:
            self.eng.client.submit(RequestSpec(rid=rid, prompt=prompt,
                                               max_new=max_new))

    def run_to_end(self, rid):
        while not self.eng.requests[rid].done:
            self.eng.step()
        return list(self.eng.requests[rid].tokens)

    def events(self):
        if self.orch is None:
            return []
        return [(e.t, e.kind, e.worker, e.detail) for e in self.orch.events]


def both(weights, scenario, **kw):
    """Run ``scenario(side)`` on both packages; returns (jax, port)."""
    return [scenario(Side(pkg, weights, **kw)) for pkg in ("jax", "port")]


@pytest.fixture(scope="module")
def ref_tokens(weights):
    def gen(s):
        s.submit("r0", PROMPT, 14)
        return s.run_to_end("r0")
    j, t = both(weights, gen)
    assert j == t
    return j


def test_orchestrator_detection_and_provisioning(weights, ref_tokens):
    def scenario(s):
        eng, orch = s.eng, s.orch
        s.submit("r0", PROMPT, 14)
        for _ in range(4):
            eng.step()
        orch.inject_failure("ew", 0, now=10.0)
        # before the detection latency nothing fires
        assert orch.tick(10.01) == []
        assert 0 not in eng.failed_ews
        fired = orch.tick(10.0 + orch.detection_latency() + 1e-6)
        assert [e.kind for e in fired] == ["detected"]
        assert 0 in eng.failed_ews
        toks = s.run_to_end("r0")
        # background provisioning restores the EW and re-points shadows
        fired = orch.tick(12.0)
        assert [e.kind for e in fired] == ["provisioned",
                                           "placement_changed"]
        assert 0 not in eng.failed_ews
        assert orch.outstanding == 0
        return toks, s.events()
    (jt, jev), (tt, tev) = both(weights, scenario, worker_init_time=1.0)
    assert jt == tt == ref_tokens
    assert tev == jev
    assert tev[-2][1:] == ("provisioned", "ew0", "shadows protect ew1")
    assert tev[-1][1:] == ("placement_changed", "gen1", "reprotect ew1")


def test_orchestrator_aw_flow(weights, ref_tokens):
    def scenario(s):
        eng, orch = s.eng, s.orch
        s.submit("r0", PROMPT, 14)
        for _ in range(4):
            eng.step()
        orch.inject_failure("aw", 0, now=5.0)
        fired = orch.tick(5.1)
        assert any("restored 1 requests" in e.detail for e in fired)
        toks = s.run_to_end("r0")
        orch.tick(6.2)                 # AW0 provisioned after T_w
        assert eng.failed_aws == set() and orch.outstanding == 0
        return toks, s.events()
    (jt, jev), (tt, tev) = both(weights, scenario, worker_init_time=1.0)
    assert jt == tt == ref_tokens
    assert tev == jev


def test_repoint_shadows_protects_other_ew(weights, ref_tokens):
    """After re-pointing shadows to protect EW1, failing EW1 is exact."""
    def scenario(s):
        s.eng.repoint_shadows(1)
        s.submit("r0", PROMPT, 14)
        for _ in range(4):
            s.eng.step()
        s.eng.fail_ew(1)
        return s.run_to_end("r0")
    j, t = both(weights, scenario)
    assert j == t == ref_tokens


def test_megascale_baseline_has_no_shadow_slots(weights):
    def scenario(s):
        assert s.eng.api.placement.num_shadow_slots == 0
        s.submit("r0", PROMPT, 10)
        return s.run_to_end("r0")
    j, t = both(weights, scenario, tarragon=False)
    assert len(t) == 10 and t == j


def test_repoint_without_shadow_slots_changes_nothing(weights):
    """An engine without shadow slots (``tarragon`` False) has no placement
    manager, and re-pointing leaves its route arrays and its stream as
    they were, in both packages."""
    def scenario(s):
        assert s.eng.placement_mgr is None
        s.submit("r0", PROMPT, 10)
        s.eng.step()
        fields = ("candidates", "slot_expert", "slot_owner", "split_slot")
        before = [np.asarray(getattr(s.eng.route_state, f)).tolist()
                  for f in fields]
        s.eng.repoint_shadows(1, now=1.0)
        assert [np.asarray(getattr(s.eng.route_state, f)).tolist()
                for f in fields] == before
        return before, s.run_to_end("r0"), s.eng.placement_generation
    j, t = both(weights, scenario, tarragon=False)
    assert t == j and len(t[1]) == 10


def test_ew_failure_without_shadow_degrades_not_crashes(weights):
    """EW1's experts have no shadows by default: tokens routed to them are
    dropped (reduced capacity), but decoding goes on, NaN-free, and both
    packages degrade alike."""
    def scenario(s):
        s.submit("r0", PROMPT, 12)
        s.eng.fail_ew(1)
        return s.run_to_end("r0")
    j, t = both(weights, scenario)
    assert len(t) == 12 and all(0 <= x < 512 for x in t)
    assert t == j


def test_elastic_entry_points_name_the_placement_plane(weights):
    """``request_scale_out``, ``request_scale_in`` and ``request_rebalance``
    on both packages (max_ew 3): the same events, plan generations and
    stream, and the refusals of the reference; an unknown worker kind and
    an unknown EW policy are refused."""
    def scenario(s):
        eng, orch = s.eng, s.orch
        orch.T_push = 0.25
        s.submit("r0", PROMPT, 14)
        eng.step()
        orch.request_scale_out(0.0)
        eng.step()
        orch.tick(1.3)                    # T_w + T_push: EW2 joins
        eng.step()
        with pytest.raises(ValueError, match="max_ew=3"):
            orch.request_scale_out(1.3)
        orch.request_rebalance(1.3)
        eng.step()
        orch.tick(1.6)
        orch.request_scale_in(2, 1.6)
        with pytest.raises(ValueError, match="not an elastic pool member"):
            orch.request_scale_in(5, 1.6)
        eng.step()
        orch.tick(1.9)
        assert orch.outstanding == 0 and eng.live_ews == {0, 1}
        return s.run_to_end("r0"), s.events(), eng.placement_generation
    (jt, jev, jgen), (tt, tev, tgen) = both(weights, scenario,
                                            worker_init_time=1.0, max_ew=3)
    assert tt == jt
    assert tev == jev
    assert tgen == jgen == 3
    assert [e[1] for e in tev] == [
        "scale_out_started", "scaled_out", "placement_changed",
        "rebalance_started", "rebalanced", "placement_changed",
        "drain_started", "scaled_in", "placement_changed"]
    orch = TOrch(_port_engine(weights[1]))
    with pytest.raises(ValueError, match="max_ew"):
        orch.request_scale_out(0.0)
    with pytest.raises(ValueError):
        orch.inject_failure("gpu", 0, 0.0)
    with pytest.raises(ValueError, match="ew_policy"):
        TOrch(orch.engine, ew_policy="restart")


# --------------------------------------------------------------------------
# selfheal and shadow additions against the reference's functions
# --------------------------------------------------------------------------

GEOMETRIES = [(8, 2, -1), (8, 4, -1), (4, 2, -1), (60, 4, -1), (8, 2, 0),
              (6, 3, 4)]


def _route_pair(placement_args, num_aw=2):
    tp = tert.default_placement(*placement_args)
    jp = jert.default_placement(*placement_args)
    return tp, jp, TRoute.healthy(tp, num_aw, device="cpu"), \
        JRoute.healthy(jp, num_aw)


def _reprotected(trs, tp, num_ew, protect):
    """The port's re-pointing as the engine does it: a fresh manager's
    ``plan_reprotect`` installed as route arrays."""
    plan = tpl.ExpertPlacementManager(tp, num_ew).plan_reprotect(protect)
    return trs._replace(
        candidates=torch.as_tensor(plan.candidates(), dtype=torch.int32),
        slot_expert=torch.as_tensor(plan.slot_expert, dtype=torch.int32))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_repoint_shadows_arrays_match_reference(geom):
    """The port's re-pointing (a ``plan_reprotect`` generation) routes as
    the reference's ``selfheal.repoint_shadows`` table: the same
    candidates and the same expert in every slot a candidate reaches. A
    shadow slot no candidate reaches holds -1 or a further replica of one
    of ``protect``'s experts, where the static table keeps a stale
    resident."""
    tp, jp, trs, jrs = _route_pair(geom)
    for protect in range(geom[1]):
        t = _reprotected(trs, tp, geom[1], protect)
        j = jsh.repoint_shadows(jrs, jp, protect)
        cand = t.candidates.numpy()
        assert np.array_equal(cand, np.asarray(j.candidates))
        reached = np.unique(cand[cand >= 0])
        got, want = t.slot_expert.numpy(), np.asarray(j.slot_expert)
        assert np.array_equal(got[reached], want[reached])
        protected = set(got[np.nonzero(trs.slot_owner.numpy() ==
                                       protect)[0]].tolist())
        unused = np.setdiff1d(np.arange(tp.num_slots), reached)
        assert set(got[unused].tolist()) <= protected | {-1}
        # the rest of the route state is untouched
        for f in ("ew_health", "aw_health", "slot_owner", "split_slot"):
            assert torch.equal(getattr(t, f), getattr(trs, f))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_experts_without_healthy_replica_match_reference(geom):
    tp, jp, trs, jrs = _route_pair(geom)
    rng = np.random.default_rng(sum(geom) + 7)
    for protect in range(geom[1]):
        t = _reprotected(trs, tp, geom[1], protect)
        j = jsh.repoint_shadows(jrs, jp, protect)
        for _ in range(4):
            health = rng.random(geom[1]) < 0.6
            t2 = t._replace(ew_health=torch.as_tensor(health))
            j2 = j._replace(ew_health=jnp.asarray(health))
            got = tsh.experts_without_healthy_replica(t2, tp)
            want = jsh.experts_without_healthy_replica(j2, jp)
            assert np.array_equal(got, want)


def test_ew_should_start_matches_reference():
    rng = np.random.default_rng(11)
    for _ in range(200):
        n = int(rng.integers(1, 6))
        args = (rng.random(n) < 0.5, rng.random(n) < 0.7,
                int(rng.integers(0, 40)), int(rng.integers(1, 40)),
                bool(rng.random() < 0.2))
        assert tsh.ew_should_start(*args) == jsh.ew_should_start(*args)


def test_shadow_memory_bytes_matches_reference():
    from repro.core import shadow as jshadow
    for geom in GEOMETRIES:
        tp, jp = tert.default_placement(*geom), jert.default_placement(*geom)
        for kw in ({}, {"bytes_per_el": 4, "gated": False}):
            assert tshadow.shadow_memory_bytes(tp, 4096, 14336, **kw) == \
                jshadow.shadow_memory_bytes(jp, 4096, 14336, **kw)


# --------------------------------------------------------------------------
# session affinity against the JAX gateway
# --------------------------------------------------------------------------

def test_session_affinity_placements_and_repins():
    """Both packages' gateways, 4 AWs of 2 slots each: sessions pin by
    their key's hash, a full home spills without re-pinning, a dead home
    re-pins the session (``session_repinned``), and an explicit session
    key wins over the rid's prefix."""
    kw = dict(max_batch=8, max_seq=48, num_aw=4, num_ew=2,
              placement="session_affinity")
    je = JEngine(reduced("mixtral_8x7b"), JEngineConfig(
        **kw, telemetry=False, flight_recorder=False), jax.random.PRNGKey(0))
    te = InferenceEngine(tget_config("mixtral_8x7b").reduced(),
                         EngineConfig(**kw), device="cpu")
    prompt = np.arange(1, 6, dtype=np.int32)
    rounds = [
        [("chat-a-0", None), ("chat-b-0", None), ("chat-a-1", None)],
        [("chat-a-2", None), ("x-0", "chat-b"), ("chat-c-0", None)],
        "fail",
        [("chat-a-3", None), ("chat-b-1", None), ("chat-c-1", None),
         ("y-9", "chat-c")],
    ]
    out = {}
    for name, eng in (("jax", je), ("port", te)):
        gw, log = eng.gateway, []
        for i, rnd in enumerate(rounds):
            if rnd == "fail":
                # fail the home of session chat-a
                home = gw.policy.pins["chat-a"]
                eng.route_state = eng.aws[home].fail(eng.route_state)
                log.append(("failed", home))
                continue
            for rid, sess in rnd:
                gw.enqueue(rid, prompt, 4, now=float(i), session=sess)
            log.append(sorted((q.rid, aw, slot)
                              for q, aw, slot in gw.admit(float(i))))
        out[name] = (log, dict(gw.policy.pins), gw.stats.session_repins,
                     [(e.t, e.kind, e.worker, e.detail)
                      for e in gw.drain_events()])
    assert out["port"] == out["jax"]
    assert out["port"][2] == 1 and out["port"][3][0][1] == \
        "session_repinned"
