"""The port's request plane against the JAX package's: twins of
``tests/test_preemption.py`` (preempt-and-requeue), the forget and
deadline cases of ``tests/test_request_api.py``, the mixed-class case of
``tests/test_compound_failures.py`` and the launcher's default engine on
the ``mixed_slo`` workload.

Each scenario runs on both packages (the reduced Mixtral at capacity
factor 4, max_batch 4, max_seq 64; the port with the reference's weights,
converted) with equal greedy streams, victims, request events
``(t, kind, rid, detail)`` and Gateway counters, and every stream of a
preempted request equals its stream from a run without preemption (the
reference's, which the port's equals). A preempted decode rewinds zero
tokens; a preempted chunked prefill resumes from its cursor.

The port gets a fresh engine for each scenario. The reference's engines
take seconds of compilation each, so scenarios share two of them (one
whole-prompt, one chunked), reset between scenarios to a fresh engine's
state (no request, slot free lists in their first order, counters, logs
and step count at zero), with the scenario's options set on them; the
scenarios that fail a worker get engines of their own.
"""
import contextlib
import dataclasses
import functools
import io
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.orchestrator import Orchestrator as JOrch
from repro.launch import serve as jserve
from repro.serving.api import RequestSpec as JSpec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core.orchestrator import Orchestrator as TOrch
from repro_torch.launch import serve as tserve
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine

PROMPT = np.arange(1, 9, dtype=np.int32)
PROMPT_B = np.arange(2, 10, dtype=np.int32)
LONG_PROMPT = np.arange(1, 33, dtype=np.int32)
ENGINE = dict(max_batch=4, max_seq=64, num_aw=2, num_ew=2)
CHUNKED = dict(chunk_token_budget=8)


def _cfg(get_config):
    cfg = get_config("mixtral_8x7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))


def _jax_engine(**kw):
    return JEngine(_cfg(jget_config), JEngineConfig(
        **{**ENGINE, **kw}, telemetry=False, flight_recorder=False),
        jax.random.PRNGKey(7))


@functools.lru_cache(maxsize=None)
def _shared_jax(chunked: bool):
    return _jax_engine(**(CHUNKED if chunked else {}))


@functools.lru_cache(maxsize=None)
def _port_params():
    return params_from_reference(_shared_jax(False).params, device="cpu")


def _reset(eng):
    """Put a shared reference engine back in a fresh engine's state."""
    assert not eng.requests and eng.gateway.depth() == 0
    for w in eng.aws:
        w.slots.restore(set())
    eng.gateway.stats = type(eng.gateway.stats)()
    eng.store.stats = type(eng.store.stats)()
    eng.scheduler.stats = type(eng.scheduler.stats)()
    if eng.chunked is not None:
        eng.chunked.stats = type(eng.chunked.stats)()
    eng.request_log, eng._release_hooks, eng._client = [], [], None
    eng.steps = 0


def _port_engine(**kw):
    return InferenceEngine(_cfg(tget_config),
                           EngineConfig(**{**ENGINE, **kw}),
                           params=_port_params(), device="cpu")


@functools.lru_cache(maxsize=None)
def healthy(prompt: tuple, max_new: int):
    """The reference's stream of one request alone, without preemption."""
    je = _shared_jax(False)
    _reset(je)
    h = je.client.submit(JSpec(rid="healthy", prompt=np.asarray(
        prompt, np.int32), max_new=max_new))
    while not h.done():
        je.step()
    je.release_request("healthy")
    return h.tokens()


class Side:
    """One package's engine behind one interface. On the reference side
    ``fresh`` False takes a shared engine and sets the options on it
    (``close`` puts them back)."""

    def __init__(self, pkg, fresh=False, **kw):
        self.pkg = pkg
        self.spec = JSpec if pkg == "jax" else RequestSpec
        self.orch_cls = JOrch if pkg == "jax" else TOrch
        self.undo = []
        if pkg == "port":
            self.eng = _port_engine(**kw)
        elif fresh:
            self.eng = _jax_engine(**kw)
        else:
            self.eng = eng = _shared_jax("chunk_token_budget" in kw)
            _reset(eng)
            for k, v in kw.items():
                if k == "chunk_token_budget":
                    self._set(eng.chunked, "budget", v)
                elif k == "preempt":
                    self._set(eng.gateway, "preemptor",
                              eng._preempt_for if v else None)
                elif k == "prefill_token_cap":
                    self._set(eng.gateway, "prefill_token_cap", v)
                else:
                    self._set(eng.ecfg, k, v)

    def _set(self, obj, name, value):
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def close(self):
        for obj, name, value in reversed(self.undo):
            setattr(obj, name, value)

    def submit(self, rid, prompt, max_new, slo_class="batch", now=0.0,
               **kw):
        return self.eng.client.submit(self.spec(
            rid=rid, prompt=prompt, max_new=max_new, slo_class=slo_class,
            **kw), now=now)

    def run_all(self, handles, max_steps=500, now=None):
        n = 0
        while not all(h.done() for h in handles) and n < max_steps:
            self.eng.step(None if now is None else now(n))
            self.release_done()
            n += 1
        assert all(h.done() for h in handles)

    def release_done(self):
        for rid in [r.rid for r in self.eng.requests.values() if r.done]:
            self.eng.release_request(rid)

    def events(self):
        return [(e.t, e.kind, e.worker, e.detail)
                for e in self.eng.request_log]

    def stats(self):
        st = self.eng.gateway.stats
        return dict(preemptions=st.preemptions, requeued=st.requeued,
                    blocked=st.blocked_ticks, admitted=st.admitted,
                    by_class={c: dict(v) for c, v in st.by_class.items()},
                    restores=self.eng.store.stats.restores)


def both(scenario, fresh=False, **kw):
    """``scenario(side)`` on both packages; returns (jax, port)."""
    out = []
    for pkg in ("jax", "port"):
        side = Side(pkg, fresh=fresh, **kw)
        try:
            out.append(scenario(side))
        finally:
            if side.pkg == "jax" and not fresh:
                for rid in list(side.eng.requests):
                    side.eng.release_request(rid)
                for e in list(side.eng.gateway.queue):
                    side.eng.gateway.drop(e.rid)
            side.close()
    return out


# --------------------------------------------------------------------------
# bit-identity
# --------------------------------------------------------------------------

def test_preempt_mid_decode_bit_identical():
    def scenario(s):
        h = s.submit("r", PROMPT, 14)
        for _ in range(4):
            s.eng.step()
        n_before = len(h.tokens())
        assert s.eng.preempt_request("r", now=1.0)
        assert h.state() == "preempted"
        # planned eviction flushes the watermark: zero tokens rewound
        assert len(s.eng.requests["r"].tokens) == n_before
        s.run_all([h])
        assert h.status().preemptions == 1
        return h.tokens(), s.events(), s.stats()
    (jt, jev, jst), (tt, tev, tst) = both(scenario)
    assert tt == jt == healthy(tuple(PROMPT), 14)
    assert tev == jev and tst == jst
    assert tst["preemptions"] == 1 and tst["restores"] == 1
    assert tev == [(1.0, "preempted", "r", "slot freed on aw0, resume@11")]


def test_preempt_mid_chunked_prefill_resumes_from_cursor():
    def scenario(s):
        h = s.submit("r", LONG_PROMPT, 10)
        s.eng.step()
        r = s.eng.requests["r"]
        assert r.prefilling and 0 < r.prefill_cursor < len(LONG_PROMPT) - 1
        cursor = r.prefill_cursor
        assert s.eng.preempt_request("r", now=1.0)
        s.run_all([h])
        st = s.eng.chunked.stats
        assert st.resumed == 1
        # the committed prefix [0, cursor) was restored, not recomputed
        assert st.prefilled_tokens["r"] == len(LONG_PROMPT) - 1
        assert st.restored_tokens["r"] == cursor
        return h.tokens(), s.events(), s.stats()
    (jt, jev, jst), (tt, tev, tst) = both(scenario, **CHUNKED)
    assert tt == jt == healthy(tuple(LONG_PROMPT), 10)
    assert tev == jev and tst == jst


def test_repeated_preemption_is_exact():
    s = Side("port")
    h = s.submit("r", PROMPT, 16)
    for k in range(3):
        for _ in range(2):
            s.eng.step()
        assert s.eng.preempt_request("r", now=float(k))
        s.eng.step()                  # the recovery entry is re-admitted
    s.run_all([h])
    assert h.tokens() == healthy(tuple(PROMPT), 16)
    assert h.status().preemptions == 3
    assert [e[1] for e in s.events()] == ["preempted"] * 3


def test_preempt_without_per_token_checkpointing_uses_bulk_path():
    """checkpoint=False: nothing streams; the eviction commits the whole
    resident prefix through the bulk range path and still resumes
    exactly."""
    def scenario(s):
        h = s.submit("r", PROMPT, 12)
        for _ in range(4):
            s.eng.step()
        assert s.eng.store.stats.updates == 0
        assert s.eng.preempt_request("r", now=1.0)
        assert s.eng.store.stats.updates > 0
        assert s.eng.store.committed_token("r") == \
            s.eng.requests["r"].pos - 1
        bytes_written = s.eng.store.stats.bytes_written
        s.run_all([h])
        return h.tokens(), s.events(), bytes_written
    (jt, jev, jb), (tt, tev, tb) = both(scenario, checkpoint=False)
    assert tt == jt == healthy(tuple(PROMPT), 12)
    assert tev == jev
    assert tb == jb > 0


# --------------------------------------------------------------------------
# a hybrid victim: each Zamba2 token's segment carries the slot's state
# --------------------------------------------------------------------------

HYBRID = dict(max_batch=4, max_seq=48, num_aw=2, num_ew=1)


@functools.lru_cache(maxsize=None)
def _hybrid_pair():
    """The reference's reduced Zamba2 engine (5 layers), the port's config
    and the converted weights, and a 12-token prompt whose greedy stream
    has no near-tie (the seed of ``test_torch_hybrid.py``)."""
    cfgs = [dataclasses.replace(g("zamba2_7b").reduced(), num_layers=5)
            for g in (jget_config, tget_config)]
    je = JEngine(cfgs[0], JEngineConfig(**HYBRID, telemetry=False,
                                        flight_recorder=False),
                 jax.random.PRNGKey(0))
    prompt = np.random.default_rng(7).integers(
        1, cfgs[0].vocab_size, size=(12,)).astype(np.int32)
    return je, cfgs[1], params_from_reference(je.params, device="cpu"), \
        prompt


@pytest.mark.parametrize("checkpoint", [True, False])
def test_preempt_hybrid_victim_as_reference(checkpoint):
    """A Zamba2 decode victim: the eviction commits its whole recurrent
    state (a flush with per-token checkpointing; the bulk range path
    without it), rewinds zero tokens, and the resumed stream equals its
    stream without preemption, with the reference's events and bytes."""
    je, tcfg, params, prompt = _hybrid_pair()
    te = InferenceEngine(tcfg, EngineConfig(**HYBRID, checkpoint=checkpoint),
                         params=params, device="cpu")
    saved = je.ecfg.checkpoint
    je.ecfg.checkpoint = checkpoint
    out = []
    try:
        for eng, spec in ((je, JSpec), (te, RequestSpec)):
            h = eng.client.submit(spec(rid="alone", prompt=prompt,
                                       max_new=8))
            while not h.done():
                eng.step()
            eng.release_request("alone")
            alone = h.tokens()
            bytes0 = eng.store.stats.bytes_written
            log0 = len(eng.request_log)
            h = eng.client.submit(spec(rid="r", prompt=prompt, max_new=8))
            for _ in range(3):
                eng.step()
            n_before = len(h.tokens())
            assert eng.preempt_request("r", now=1.0)
            assert len(eng.requests["r"].tokens) == n_before
            assert eng.store.committed_token("r") == \
                eng.requests["r"].pos - 1
            bytes_commit = eng.store.stats.bytes_written - bytes0
            while not h.done():
                eng.step()
            eng.release_request("r")
            out.append((alone, h.tokens(), [(e.t, e.kind, e.worker, e.detail)
                                     for e in eng.request_log[log0:]],
                        bytes_commit, h.status().preemptions))
    finally:
        je.ecfg.checkpoint = saved
    (ja, jt, jev, jb, jn), (ta, tt, tev, tb, tn) = out
    assert tt == jt == ta == ja and len(tt) == 8
    assert tev == jev and [e[1] for e in tev] == ["preempted"]
    assert tb == jb > 0 and tn == jn == 1


# --------------------------------------------------------------------------
# the Gateway's preemptor
# --------------------------------------------------------------------------

def test_interactive_preempts_saturating_batch():
    prompts = {f"b{i}": PROMPT + i for i in range(4)}

    def scenario(s):
        bh = [s.submit(rid, p, 24) for rid, p in prompts.items()]
        for _ in range(3):
            s.eng.step()
        assert all(not w.has_capacity() for w in s.eng.aws)
        hi = s.submit("int", PROMPT + 9, 4, slo_class="interactive",
                      now=1.0)
        # placed at once: a batch victim was checkpointed out of its slot
        assert hi.state() == "placed"
        victims = [h.rid for h in bh if h.state() == "preempted"]
        s.run_all(bh + [hi])
        return ({h.rid: h.tokens() for h in bh + [hi]}, victims,
                s.events(), s.stats())
    (jt, jv, jev, jst), (tt, tv, tev, tst) = both(scenario)
    assert tt == jt and tv == jv == ["b3"]
    assert tev == jev and tst == jst
    assert tst["preemptions"] == 1
    for rid, p in prompts.items():
        assert tt[rid] == healthy(tuple(p), 24), rid
    assert tt["int"] == healthy(tuple(PROMPT + 9), 4)


@pytest.mark.parametrize("slo_class,preempt", [("standard", True),
                                               ("interactive", False)],
                         ids=["standard_never_preempts",
                              "preempt_disabled_by_config"])
def test_no_preemption(slo_class, preempt):
    def scenario(s):
        for i in range(4):
            s.submit(f"b{i}", PROMPT, 30)
        h = s.submit("s", PROMPT, 4, slo_class=slo_class)
        assert h.state() == "queued"
        return s.stats()
    jst, tst = both(scenario, preempt=preempt)
    assert tst == jst and tst["preemptions"] == 0


# --------------------------------------------------------------------------
# victim selection
# --------------------------------------------------------------------------

def _victim_scenario(s):
    """b-long (40 new) then three short batch requests; an interactive
    arrival needs a slot."""
    hl = s.submit("b-long", PROMPT, 40)
    for _ in range(2):
        s.eng.step()
    hs = [s.submit(f"b-short{i}", PROMPT + i, 6, now=1.0) for i in range(3)]
    for _ in range(2):
        s.eng.step()
    assert all(not w.has_capacity() for w in s.eng.aws)
    hi = s.submit("int", PROMPT + 9, 2, slo_class="interactive", now=2.0)
    assert hi.state() == "placed"
    states = {h.rid: h.state() for h in [hl] + hs}
    s.run_all([hl, hi] + hs)
    return states, s.events(), s.stats(), hl.tokens()


@pytest.mark.parametrize("policy", ["remaining_work", "youngest"])
def test_victim_policy(policy):
    """remaining_work evicts the request with the most work left (b-long,
    despite its earlier arrival); youngest evicts the latest arrival."""
    (js, jev, jst, jt), (ts, tev, tst, tt) = both(_victim_scenario,
                                                  victim_policy=policy)
    assert ts == js and tev == jev and tst == jst and tt == jt
    preempted = [r for r, st in ts.items() if st == "preempted"]
    if policy == "remaining_work":
        assert preempted == ["b-long"]
    else:
        assert len(preempted) == 1 and preempted[0].startswith("b-short")
    assert tt == healthy(tuple(PROMPT), 40)


def test_controller_policy_names_the_control_plane():
    with pytest.raises(ValueError, match="control plane"):
        _port_engine(victim_policy="controller")
    with pytest.raises(ValueError, match="victim_policy"):
        _port_engine(victim_policy="oldest")


def test_remaining_work_weighs_prefill_debt():
    """With equal max_new, the request still prefilling owes its prompt
    tail too: it is the victim, and it resumes exactly from its cursor."""
    def scenario(s):
        done_h = [s.submit(f"d{i}", PROMPT + i, 20) for i in range(3)]
        for _ in range(3):
            s.eng.step()
        hp = s.submit("pf", LONG_PROMPT, 20, now=1.0)
        s.eng.step()
        r = s.eng.requests["pf"]
        assert r.prefilling and r.prefill_cursor < len(LONG_PROMPT) - 1
        hi = s.submit("int", PROMPT + 9, 2, slo_class="interactive",
                      now=2.0)
        assert hi.state() in ("placed", "prefilling")
        assert hp.state() == "preempted"
        assert all(h.state() != "preempted" for h in done_h)
        s.run_all(done_h + [hp, hi])
        return hp.tokens(), s.events(), s.stats()
    (jt, jev, jst), (tt, tev, tst) = both(scenario, chunk_token_budget=4)
    assert tt == jt == healthy(tuple(LONG_PROMPT), 20)
    assert tev == jev and tst == jst


def test_preemption_adds_no_step_keys():
    s = Side("port")
    h = s.submit("r", PROMPT, 20)
    for _ in range(3):
        s.eng.step()
    keys = s.eng.decode_plane.captures()
    assert s.eng.preempt_request("r", now=1.0)
    s.run_all([h])
    assert s.eng.decode_plane.captures() == keys


# --------------------------------------------------------------------------
# the token cap
# --------------------------------------------------------------------------

def test_token_cap_admission_matches_reference():
    """prefill_token_cap 16 over an 8-token budget: a prompt waits while
    the admitted-but-unprefilled tokens would pass the cap; the first
    admission of a tick always passes, and recovery entries bypass it."""
    def scenario(s):
        hs = [s.submit(f"c{i}", LONG_PROMPT[:12 + i], 6, slo_class="standard")
              for i in range(4)]
        queued = [h.state() for h in hs]
        assert s.eng.preempt_request("c0", now=0.5)
        s.run_all(hs, now=lambda n: 1.0 + 0.1 * n)
        return queued, [h.tokens() for h in hs], s.stats(), s.events()
    (jq, jt, jst, jev), (tq, tt, tst, tev) = both(
        scenario, chunk_token_budget=8, prefill_token_cap=16)
    assert tq == jq and tt == jt and tst == jst and tev == jev
    assert tq.count("queued") >= 2 and tst["blocked"] > 0


# --------------------------------------------------------------------------
# request API: forget and deadlines (tests/test_request_api.py)
# --------------------------------------------------------------------------

def test_forget_drops_terminal_handles_only():
    s = Side("port")
    h = s.submit("r", PROMPT, 3, slo_class="standard")
    with pytest.raises(ValueError, match="still live"):
        s.eng.client.forget("r")
    while not h.done():
        s.eng.step()
    assert s.eng.client.forget("r")
    assert s.eng.client.handle("r") is None
    assert not s.eng.client.forget("r")
    assert h.tokens()                  # the caller's reference lives on


def test_deadline_missed_emitted_once_and_request_survives():
    def scenario(s):
        for i in range(4):
            s.submit(f"b{i}", PROMPT, 12)
        h = s.submit("d", PROMPT, 4, slo_class="standard", deadline=0.1,
                     completion_deadline=0.5)
        s.run_all([h], max_steps=200, now=lambda n: 1.0 + 0.02 * n)
        assert h.done() and len(h.tokens()) == 4
        st = h.status()
        assert st.deadline_missed and st.completion_deadline_missed
        return s.events(), s.stats()
    (jev, jst), (tev, tst) = both(scenario)
    assert tev == jev and tst == jst
    assert tst["by_class"]["standard"]["deadline_missed"] == 1
    assert tst["by_class"]["standard"]["completion_deadline_missed"] == 1
    assert [e[1:3] for e in tev] == [("deadline_missed", "d")] * 2


def test_crash_recovery_of_on_time_request_is_not_a_deadline_miss():
    def scenario(s):
        for i in range(3):
            s.submit(f"f{i}", PROMPT + i, 4, slo_class="standard")
        h = s.submit("r", PROMPT, 12, slo_class="standard", deadline=0.5)
        aw_r = s.eng.requests["r"].aw
        s.eng.step(now=0.1)
        assert 0 <= s.eng.requests["r"].t_first_token <= 0.5
        s.eng.fail_aw(aw_r)
        s.eng.recover_aw_requests(now=1.0)
        assert s.eng.gateway.find("r") is not None
        s.run_all([h], max_steps=100, now=lambda n: 1.1 + 0.02 * n)
        return h.tokens(), s.events(), s.stats()
    (jt, jev, jst), (tt, tev, tst) = both(scenario, fresh=True)
    assert tt == jt and tev == jev == [] and tst == jst
    assert "deadline_missed" not in tst["by_class"]["standard"]


def test_cancel_emits_events_as_reference():
    def scenario(s):
        for i in range(4):
            s.submit(f"b{i}", PROMPT, 12)
        hq = s.submit("q", PROMPT, 4, slo_class="standard")
        s.eng.step()
        assert hq.state() == "queued"
        assert hq.cancel(now=0.5) and s.eng.client.cancel("b1", now=0.6)
        assert not s.eng.cancel_request("nope")
        return s.events(), s.stats()
    (jev, jst), (tev, tst) = both(scenario)
    assert tev == jev and tst == jst
    assert [e[1:] for e in tev] == [("cancelled", "q", "while queued"),
                                    ("cancelled", "b1", "cancelled")]


# --------------------------------------------------------------------------
# compound: preemption under AW and EW failure
# --------------------------------------------------------------------------

def test_mixed_class_workload_with_preemption_under_aw_ew_failure():
    """A batch wave fills the pool, an interactive arrival preempts a
    victim, then an AW and an EW die in one detection window: every
    request finishes with its stream without failure or preemption, and
    the orchestrator's events equal the reference's."""
    prompts = {f"b{i}": PROMPT + i for i in range(4)}
    prompts["int"] = PROMPT_B

    def scenario(s):
        orch = s.orch_cls(s.eng, worker_init_time=1.0)
        hs = {rid: s.submit(rid, prompts[rid], 18)
              for rid in ("b0", "b1", "b2", "b3")}
        for _ in range(3):
            s.eng.step()
        hs["int"] = s.submit("int", prompts["int"], 18,
                             slo_class="interactive", now=4.0)
        assert s.eng.gateway.stats.preemptions == 1
        orch.inject_failure("aw", 0, now=5.0)
        orch.inject_failure("ew", 0, now=5.0)
        orch.tick(5.0 + orch.detection_latency() + 1e-6)
        n = 0
        while not all(h.done() for h in hs.values()) and n < 600:
            s.eng.step()
            orch.tick(6.0 + 0.01 * n)
            s.release_done()
            n += 1
        assert any(e.kind == "preempted" for e in orch.events)
        assert s.eng.store.stats.restores >= 2
        return ({rid: h.tokens() for rid, h in hs.items()},
                [(e.t, e.kind, e.worker, e.detail) for e in orch.events])
    (jt, jev), (tt, tev) = both(scenario, fresh=True)
    assert tt == jt and tev == jev
    for rid, p in prompts.items():
        assert tt[rid] == healthy(tuple(p), 18), rid


# --------------------------------------------------------------------------
# the launcher's defaults preempt in both packages
# --------------------------------------------------------------------------

def test_launcher_mixed_slo_preempts_as_reference(monkeypatch):
    """``--workload mixed_slo`` through both launchers at their default
    engine options: the same preemptions, per-class counters and
    orchestrator events. No token limit but max_new ends a request, so
    these lines do not depend on the two launchers' weights."""
    args = ["--workload", "mixed_slo", "--rps", "3", "--duration", "1.5"]

    def lines(text):
        keep = ("requests finished", "request plane", "interactive:",
                "batch:", "standard:", "[orch")
        return [ln.strip() for ln in text.splitlines()
                if any(ln.strip().startswith(k) for k in keep)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--device", "cpu"] + args)
    got = lines(out.getvalue())
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["serve", "--no-telemetry"] + args)
    with contextlib.redirect_stdout(out):
        jserve.main()
    want = lines(out.getvalue())
    assert got == want
    assert any("preempted" in ln for ln in got if ln.startswith("[orch"))
    assert "request plane: preemptions=0" not in got
