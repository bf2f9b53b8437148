"""The port's host modules of the control plane against the JAX
package's: the cost model (``core/costmodel.py``) and the failover
simulator (``core/events.py``, every function but ``timeline_from_bus``)
on the same inputs to 1e-12 relative, and the workload generator
(``data/workloads.py``) request for request, prompts included."""
import dataclasses

import numpy as np
import pytest

from repro.core import costmodel as jcm
from repro.core import events as jev
from repro.data import workloads as jwl
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.core import costmodel as tcm
from repro_torch.core import events as tev
from repro_torch.data import workloads as twl

REL = 1e-12
LAYERS = [(32, 0, 1), (32, 16, 5), (8, 3, 64), (56, 55, 128)]


def close(a, b):
    """Equal structure; floats and arrays within REL relative."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            close(x, y)
    elif isinstance(a, (float, np.ndarray, np.floating)):
        np.testing.assert_allclose(a, b, rtol=REL, atol=0)
    else:
        assert a == b


def profiles():
    return [(j, getattr(tcm, n)) for n, j in
            (("VLLM_PROFILE", jcm.VLLM_PROFILE),
             ("MEGASCALE_PROFILE", jcm.MEGASCALE_PROFILE))]


def test_profiles_and_constants_match():
    for j, t in profiles():
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(jcm.TarragonProfile()) == \
        dataclasses.asdict(tcm.TarragonProfile())
    assert tcm.FULL_RESTART_EXTRA == jcm.FULL_RESTART_EXTRA


@pytest.mark.parametrize("fn", [
    "stall_monolithic", "stall_decoupled_aw", "stall_decoupled_ew",
    "gputime_monolithic", "gputime_decoupled_aw", "gputime_decoupled_ew",
    "gputime_tarragon_aw", "gputime_tarragon_ew"])
def test_stall_and_gputime_equations(fn):
    for jp, tp in profiles():
        for args in LAYERS:
            close(getattr(tcm, fn)(tp, *args), getattr(jcm, fn)(jp, *args))


def test_tarragon_stall_equations():
    tt = tcm.TarragonProfile(detect=0.02, restore_fixed=0.03)
    jt = jcm.TarragonProfile(detect=0.02, restore_fixed=0.03)
    for jp, tp in profiles():
        for args in LAYERS:
            for n in (1, 17, 4096):
                close(tcm.stall_tarragon_aw(tp, tt, *args, n),
                      jcm.stall_tarragon_aw(jp, jt, *args, n))
            close(tcm.stall_tarragon_ew(tp, tt, *args),
                  jcm.stall_tarragon_ew(jp, jt, *args))


def test_traffic_model():
    for d, h, kv, k in ((4096, 32, 8, 2), (2048, 16, 16, 8), (7168, 64, 8,
                                                                 8)):
        for b in (1, 2, 4):
            assert tcm.kv_segment_bytes(d, h, kv, b) == \
                jcm.kv_segment_bytes(d, h, kv, b)
            assert tcm.expert_traffic_bytes(d, k, b) == \
                jcm.expert_traffic_bytes(d, k, b)
        close(tcm.checkpoint_traffic_ratio(d, h, kv, k),
              jcm.checkpoint_traffic_ratio(d, h, kv, k))


def sim_configs():
    """(port SimConfig, reference SimConfig) pairs: the defaults, the vLLM
    profile at another scale, and a short run with a failure early."""
    out = []
    for kw, prof in (({}, "MEGASCALE_PROFILE"),
                     (dict(num_layers=8, num_requests=7, duration=40.0,
                           fail_time=11.3, sample_dt=0.25), "VLLM_PROFILE"),
                     (dict(num_ew=2, expert_time_frac=0.3, fail_time=5.0,
                           duration=20.0), "MEGASCALE_PROFILE")):
        out.append((tev.SimConfig(profile=getattr(tcm, prof), **kw),
                    jev.SimConfig(profile=getattr(jcm, prof), **kw)))
    return out


def timeline_close(a, b):
    assert a.mode == b.mode and a.events == b.events
    for f in ("t", "throughput", "tbt"):
        close(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    close(float(a.stall), float(b.stall))


@pytest.mark.parametrize("fn,kw", [
    ("simulate_megascale_failure", {}),
    ("simulate_tarragon_aw_failure", {}),
    ("simulate_tarragon_ew_failure", {}),
    ("simulate_tarragon_scale_out", {}),
    ("simulate_tarragon_scale_out", {"t_scale": 3.0, "t_push": 0.5}),
    ("simulate_tarragon_scale_in", {}),
    ("simulate_tarragon_scale_in", {"t_scale": 2.5, "t_push": 2.0}),
    ("simulate_tarragon_promotion", {}),
    ("simulate_preemption_restore", {}),
    ("simulate_preemption_restore", {"t_evict": 4.0, "wait": 0.25}),
    ("simulate_preemption_recompute", {}),
    ("simulate_preemption_recompute", {"t_evict": 4.0, "wait": 0.25})])
def test_simulated_timelines(fn, kw):
    for tc, jc in sim_configs():
        timeline_close(getattr(tev, fn)(tc, **kw), getattr(jev, fn)(jc, **kw))


def test_summaries_link_trace_and_checkpoint_schemes():
    for tc, jc in sim_configs():
        close(tev.failover_summary(tc), jev.failover_summary(jc))
        for wait in (1.0, 0.1):
            close(tev.preemption_summary(tc, wait=wait),
                  jev.preemption_summary(jc, wait=wait))
        for kw in ({}, dict(n_layers=3, link_gbps=25.0,
                            tokens_per_dispatch=512, d_model=7168,
                            top_k=8)):
            close(tev.link_trace(tc, **kw), jev.link_trace(jc, **kw))
        for scheme in ("none", "incremental", "pause"):
            for kw in ({}, dict(interval_tokens=2, kv_tokens=64,
                                link_gbps=10.0)):
                close(tev.checkpoint_scheme_throughput(tc, scheme, **kw),
                      jev.checkpoint_scheme_throughput(jc, scheme, **kw))
        with pytest.raises(ValueError):
            tev.checkpoint_scheme_throughput(tc, "other")


KINDS = ["random", "sharegpt", "long_prompt_burst", "skewed_expert_load",
         "mixed_slo", "multi_turn_chat"]


@pytest.mark.parametrize("kind", KINDS)
def test_make_workload_matches_reference(kind):
    for seed in range(3):
        kw = dict(seed=seed, max_prompt=64, max_new=24)
        got = twl.make_workload(kind, 6.0, 3.0, **kw)
        want = jwl.make_workload(kind, 6.0, 3.0, **kw)
        assert [dataclasses.asdict(r) for r in got] == \
            [dataclasses.asdict(r) for r in want]
        assert got, f"{kind} seed {seed}: empty workload"
        for a, b in zip(got, want):
            pa, pb = a.prompt_tokens(512), b.prompt_tokens(512)
            assert pa.dtype == pb.dtype and np.array_equal(pa, pb)
    with pytest.raises(ValueError):
        twl.make_workload("other", 1.0, 1.0)


def test_arrivals_chat_history_and_lm_batches():
    for seed in range(3):
        for fn in ("poisson_arrivals", "burst_arrivals"):
            a = getattr(twl, fn)(5.0, 4.0, np.random.default_rng(seed))
            b = getattr(jwl, fn)(5.0, 4.0, np.random.default_rng(seed))
            assert np.array_equal(a, b)
        for turn in range(3):
            assert np.array_equal(twl.chat_history_tokens(seed, turn, 97),
                                  jwl.chat_history_tokens(seed, turn, 97))
        for learnable in (True, False):
            for x, y in zip(twl.lm_batches(97, 2, 8, 3, seed, learnable),
                            jwl.lm_batches(97, 2, 8, 3, seed, learnable)):
                assert x.keys() == y.keys()
                for k in x:
                    assert np.array_equal(x[k], y[k])
