"""The port's decode segments (serving/decode_loop.py) on the CPU, against
the per-step port and the JAX engine: twins of the reference's
tests/test_device_decode.py and test_paged_kv.py at their reduced Mixtral
(max_batch 4, max_seq 64, capacity factor 4).

  * ``decode_segment_len=8`` gives bitwise the streams of 1, greedy and
    stochastic, with the stop mask honoured exactly; a mid-segment AW
    crash rewinds to the committed watermark and replays bitwise; paged
    equals contiguous at seg 4 under ``fail_aw(0)``; a reduced Gemma2's
    rings wrap inside segments and the streams still equal seg 1's;
  * the greedy seg-8 streams and the host-sync counts equal the JAX
    engine's (the sampler hash is the port's own, so stochastic streams
    compare only within the port);
  * the hybrid refuses segments, as the reference does;
  * the step's key set (``captures``) stays fixed across sampling changes,
    segment tails and failures, and the step reads a RouteState copy that
    follows ``fail_ew`` and ``repoint_shadows``;
  * the segment drain's range gather reads each token at its own ring slot,
    where the reference's clamped slice reads other positions (pinned).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.serving.api import RequestSpec as JSpec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.models import get_model as tget_model
from repro_torch.serving.api import RequestSpec, SamplingParams
from repro_torch.serving.engine import EngineConfig, InferenceEngine

PROMPT = np.arange(1, 9, dtype=np.int32)
SPECS = [dict(rid="a", prompt=PROMPT, max_new=5),       # ends mid-segment
         dict(rid="b", prompt=np.arange(2, 12, dtype=np.int32),
              max_new=11),                              # ends mid-segment 2
         dict(rid="c", prompt=np.arange(5, 12, dtype=np.int32),
              max_new=16)]                              # two full segments
STOCHASTIC = SamplingParams(greedy=False, temperature=1.1, top_k=12)
ENGINE = dict(max_batch=4, max_seq=64, num_aw=2, num_ew=2)


def _cap4(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))


@functools.lru_cache(maxsize=None)
def _reference(arch: str, seg_len: int):
    """The JAX engine (seed 7, as the reference's tests), its store on."""
    cfg = jget_config(arch).reduced()
    if cfg.moe.enabled:
        cfg = _cap4(cfg)
    return JEngine(cfg, JEngineConfig(
        **ENGINE, decode_segment_len=seg_len, telemetry=False,
        flight_recorder=False), jax.random.PRNGKey(7))


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    return params_from_reference(_reference(arch, 8).params, device="cpu")


def make_engine(arch="mixtral_8x7b", **kw):
    cfg = tget_config(arch).reduced()
    if cfg.moe.enabled:
        cfg = _cap4(cfg)
    return InferenceEngine(cfg, EngineConfig(**{**ENGINE, **kw}),
                           params=_params(arch), device="cpu")


def run_to_done(eng, handles, max_steps=300):
    n = 0
    while not all(h.done() for h in handles) and n < max_steps:
        eng.step()
        n += 1
    assert all(h.done() for h in handles)


def gen_all(eng, specs, sampling=None, spec_cls=RequestSpec):
    handles = [eng.client.submit(spec_cls(**s, sampling=sampling)
                                 if sampling else spec_cls(**s))
               for s in specs]
    run_to_done(eng, handles)
    out = {h.rid: h.tokens() for h in handles}
    for h in reversed(handles):
        eng.release_request(h.rid)
    return out


@pytest.mark.parametrize("sampling", [None, STOCHASTIC],
                         ids=["greedy", "stochastic"])
def test_segment_bit_identical_to_per_step(sampling):
    ref = gen_all(make_engine(decode_segment_len=1), SPECS, sampling)
    seg = gen_all(make_engine(decode_segment_len=8), SPECS, sampling)
    assert seg == ref
    for s in SPECS:                  # the stop mask honoured exactly
        assert len(seg[s["rid"]]) == s["max_new"]


def test_greedy_segment_streams_equal_reference():
    want = gen_all(_reference("mixtral_8x7b", 8), SPECS, spec_cls=JSpec)
    assert gen_all(make_engine(decode_segment_len=8), SPECS) == want


def test_segment_store_equals_per_step_store():
    """The segment drain hands every AW's checkpointer the tokens, values
    and bytes of the per-step path: the committed watermarks, token values
    and segment bits are equal at the end of a run, and no row wrote KV
    past its end."""
    engines = [make_engine(decode_segment_len=n) for n in (1, 8)]
    for eng in engines:
        handles = [eng.client.submit(RequestSpec(**s)) for s in SPECS]
        run_to_done(eng, handles)
        # the stop mask: a row that finished mid-segment wrote no KV past
        # its last decode input
        for r in eng.requests.values():
            for layer in eng.cache["layers"]:
                held = layer["pos"][r.slot]
                assert sorted(held[held >= 0].tolist()) == list(range(r.pos))
    one, eight = (e.store for e in engines)
    assert one.stats.bytes_written == eight.stats.bytes_written > 0
    for rid in ("a", "b", "c"):
        a, b = one._logs[rid], eight._logs[rid]
        assert a.committed_token == b.committed_token
        assert a.token_values == b.token_values
        assert sorted(a.segments) == sorted(b.segments)
        for t in a.segments:
            for x, y in zip(a.segments[t], b.segments[t]):
                assert torch.equal(x, y)


def test_segment_mid_failure_rewinds_and_replays_bit_identical():
    """AW crash between a segment's device run and its checkpoint commit:
    the uncommitted segment is rewound (at most seg_len tokens) and
    recomputed bitwise through the ordinary restore."""
    kw = dict(decode_segment_len=8)
    ref = gen_all(make_engine(**kw),
                  [dict(rid="r0", prompt=PROMPT, max_new=22)], STOCHASTIC)
    eng = make_engine(**kw)
    h = eng.client.submit(RequestSpec(rid="r0", prompt=PROMPT, max_new=22,
                                      sampling=STOCHASTIC))
    r = eng.requests["r0"]
    assert r.aw == 0
    eng.step()                       # segment 1: checkpointed and flushed
    committed = len(r.tokens)
    # the crash window: the next segment drains to the host but its
    # checkpoint writes never reach the store
    eng.aws[0].checkpointer.flush = lambda: None
    eng.aws[0].checkpointer.reorder_window = 1 << 30
    eng.step()
    assert len(r.tokens) > committed
    eng.fail_aw(0)
    assert eng.recover_aw_requests() == ["r0"]
    assert r.aw == 1
    assert len(r.tokens) == committed        # rewound to the watermark
    run_to_done(eng, [h])
    assert h.tokens() == ref["r0"]
    assert eng.store.stats.restores == 1


def _sync_counts(make, spec_cls):
    """The reference's scenario: drains per step at seg 1, per segment at
    seg 8 (each up to 8 tokens of the request)."""
    one = make(decode_segment_len=1)
    one.client.submit(spec_cls(rid="r", prompt=PROMPT, max_new=9))
    steps, per_step = 0, []
    while not one.requests["r"].done:
        per_step.append(sum(len(t) for t in one.step().values()))
        steps += 1
    eight = make(decode_segment_len=8)
    eight.client.submit(spec_cls(rid="r", prompt=PROMPT, max_new=9))
    firsts = [len(eight.step()["r"]), eight.gateway.stats.host_syncs]
    eight.step()
    out = (one.gateway.stats.host_syncs, steps, max(per_step), firsts,
           eight.gateway.stats.host_syncs, eight.requests["r"].done)
    for eng in (one, eight):
        eng.release_request("r")
    return out


def test_host_syncs_per_step_and_per_segment_equal_reference():
    def jmake(decode_segment_len):
        eng = _reference("mixtral_8x7b", decode_segment_len)
        eng.gateway.stats.host_syncs = 0
        return eng
    port = _sync_counts(make_engine, RequestSpec)
    assert port == _sync_counts(jmake, JSpec)
    syncs1, steps, most, firsts, syncs8, done = port
    assert syncs1 == steps and most == 1
    assert firsts == [8, 1] and syncs8 == 2 and done


def test_hybrid_refuses_segments():
    jcfg, tcfg = (get("zamba2_7b").reduced()
                  for get in (jget_config, tget_config))
    assert not jget_model(jcfg).supports_decode_segments
    assert not tget_model(tcfg, device="cpu").supports_decode_segments
    assert tget_model(tget_config("mixtral_8x7b").reduced(),
                      device="cpu").supports_decode_segments
    with pytest.raises(ValueError, match="decode_segment_len"):
        InferenceEngine(tcfg, EngineConfig(**ENGINE, decode_segment_len=8),
                        device="cpu")


def test_step_keys_stable_across_sampling_tails_and_failures():
    """Segment tails, finished rows, recoveries and SamplingParams changes
    are buffer writes: the key set of the step (its captures on the card)
    does not grow after warm-up."""
    eng = make_engine(decode_segment_len=8)
    gen_all(eng, [dict(rid="w", prompt=PROMPT, max_new=6)],
            SamplingParams(greedy=False, temperature=1.2, top_k=6))
    base = eng.decode_plane.captures()
    assert base == 1
    for i, samp in enumerate([
            SamplingParams(greedy=True),
            SamplingParams(greedy=False, temperature=0.4, top_k=3, seed=7),
            None]):
        gen_all(eng, [dict(rid=f"q{i}", prompt=PROMPT, max_new=3 + 5 * i)],
                samp)
    h = eng.client.submit(RequestSpec(rid="f", prompt=PROMPT, max_new=20))
    eng.step()
    eng.fail_aw(eng.requests["f"].aw)
    eng.recover_aw_requests()
    eng.fail_ew(0)
    run_to_done(eng, [h])
    assert eng.decode_plane.captures() == base


def test_step_routes_by_the_engine_route_state():
    """The step reads the plane's RouteState copy, which is refilled from
    the engine's before every dispatch: after ``fail_ew(0)`` no token goes
    to a slot on EW0 and the shadows take them; after ``repoint_shadows``
    the copy holds the new slot tables. A copy left stale would route to
    the dead EW with no error."""
    eng = make_engine(decode_segment_len=4)
    plane = eng.decode_plane
    owner = eng.route_state.slot_owner.numpy()
    shadow = np.arange(len(owner)) >= eng.api.placement.primary_slots
    handles = [eng.client.submit(RequestSpec(**s)) for s in SPECS]
    eng.step()
    assert plane.loads[:, owner == 0].sum() > 0
    eng.fail_ew(0)
    eng.step()
    for got, want in zip(plane.route_state, eng.route_state):
        assert torch.equal(got, want)
    assert plane.loads[:, owner == 0].sum() == 0
    assert plane.loads[:, shadow].sum() > 0
    eng.provision_ew(0, repoint_protect=1)
    eng.step()
    for got, want in zip(plane.route_state, eng.route_state):
        assert torch.equal(got, want)
    run_to_done(eng, handles)


def test_segment_preempted_victim_bit_identical():
    """A victim preempted after a full segment resumes from its committed
    cursor (a planned eviction rewinds nothing) and finishes with the
    per-step engine's stream."""
    spec = dict(rid="v", prompt=PROMPT, max_new=20, slo_class="batch")
    ref = gen_all(make_engine(decode_segment_len=1), [spec], STOCHASTIC)
    eng = make_engine(decode_segment_len=8)
    h = eng.client.submit(RequestSpec(**spec, sampling=STOCHASTIC))
    eng.step()                        # one full segment decoded
    n_before = len(h.tokens())
    assert 0 < n_before < 20
    keys = eng.decode_plane.captures()
    assert eng.preempt_request("v", now=1.0)
    assert h.state() == "preempted"
    assert len(eng.requests["v"].tokens) == n_before
    run_to_done(eng, [h])
    assert h.tokens() == ref["v"]
    assert h.status().preemptions == 1
    assert eng.decode_plane.captures() == keys


def test_segment_loads_reach_the_manager_as_reference():
    """Each step of a segment is one record of the placement manager's
    load EMAs, from the segment's one drain, as in the reference: after
    the same greedy seg-8 run the EMAs are equal, and the host syncs are
    one a segment."""
    from repro.core.placement import LoadStats
    jeng = _reference("mixtral_8x7b", 8)
    jm = jeng.placement_mgr
    jm.load = LoadStats(np.zeros_like(jm.load.ema_expert),
                        np.zeros_like(jm.load.ema_ew), decay=jm.load.decay)
    gen_all(jeng, SPECS, spec_cls=JSpec)
    eng = make_engine(decode_segment_len=8)
    gen_all(eng, SPECS)
    tm = eng.placement_mgr
    assert tm.load.total_recorded == jm.load.total_recorded > 0
    np.testing.assert_array_equal(tm.load.ema_expert, jm.load.ema_expert)
    np.testing.assert_array_equal(tm.load.ema_ew, jm.load.ema_ew)
    assert eng.gateway.stats.host_syncs == eng.steps


@pytest.mark.parametrize("seg_len", [1, 4])
def test_paged_matches_contiguous_under_aw_failure(seg_len):
    """AW0 dies mid-run (mid-segment at seg 4) with requests in flight;
    recovery replays committed checkpoints into fresh pages and every
    request finishes with the contiguous engine's tokens."""
    results = {}
    for mode, kw in [("contig", {}), ("paged", dict(kv_page_tokens=16))]:
        eng = make_engine(decode_segment_len=seg_len, chunk_token_budget=8,
                          **kw)
        hs = []
        for i in range(3):
            p = np.random.default_rng(100 + i).integers(
                1, 200, size=(12 + 3 * i,)).astype(np.int32)
            hs.append(eng.client.submit(RequestSpec(
                rid=f"s{i}-0", prompt=p, max_new=6)))
        for _ in range(6):
            eng.step()
        eng.fail_aw(0)
        eng.recover_aw_requests(now=float(eng.steps))
        if eng.pages is not None:
            eng.pages.check()
        for _ in range(400):             # releasing what finishes frees
            if all(h.done() for h in hs):    # slots for the recovered
                break
            eng.step()
            for rid in [r.rid for r in eng.requests.values() if r.done]:
                eng.release_request(rid)
        for rid in [r.rid for r in eng.requests.values() if r.done]:
            eng.release_request(rid)
        results[mode] = [list(h.tokens()) for h in hs]
        assert eng.store.stats.restores > 0
        if eng.pages is not None:
            eng.pages.check()
            assert eng.pages.stats()["pages_used"] == 0
    assert results["paged"] == results["contig"]
    assert all(len(s) == 6 for s in results["paged"])


def test_ring_segments_equal_per_step_and_reference():
    """A reduced Gemma2 (16-token local rings) whose rings wrap inside
    segments: seg 8 equals seg 1 and the JAX engine's seg-8 stream, also
    after ``fail_aw(0)`` mid-run, restored from segments that crossed the
    wrap."""
    specs = [dict(rid="g0", prompt=np.arange(1, 11, dtype=np.int32),
                  max_new=20),
             dict(rid="g1", prompt=np.arange(3, 8, dtype=np.int32),
                  max_new=30)]
    want = gen_all(_reference("gemma2_2b", 8), specs, spec_cls=JSpec)
    got = {}
    for seg in (1, 8):
        eng = make_engine("gemma2_2b", decode_segment_len=seg)
        handles = [eng.client.submit(RequestSpec(**s)) for s in specs]
        while min(len(h.tokens()) for h in handles) < 12:
            eng.step()
        eng.fail_aw(0)
        assert eng.recover_aw_requests()
        eng.provision_aw(0)
        run_to_done(eng, handles)
        got[seg] = {h.rid: h.tokens() for h in handles}
    assert got[8] == got[1] == want


def test_range_gather_across_a_ring_wrap_against_reference():
    """The segment drain's range gather reads every token at its own ring
    slot (t % Sc). The reference slices ``start % Sc`` with a clamped
    dynamic slice: a range that crosses the wrap of its reduced Gemma2's
    16-token ring stores the KV of other positions (tokens 10-17 of this
    run carry positions 8-15 in the local layer). Pinned as a reference
    behaviour; the port keeps the per-token semantics."""
    spec = dict(rid="wrap", prompt=np.arange(1, 11, dtype=np.int32),
                max_new=20)
    jeng = _reference("gemma2_2b", 8)
    teng = make_engine("gemma2_2b", decode_segment_len=8)
    for eng, spec_cls in ((jeng, JSpec), (teng, RequestSpec)):
        run_to_done(eng, [eng.client.submit(spec_cls(**spec))])
    jlog, tlog = jeng.store._logs["wrap"], teng.store._logs["wrap"]
    jeng.release_request("wrap")
    assert sorted(jlog.segments) == sorted(tlog.segments)
    local, glob = (jeng.layout.paths.index(f"blocks/{i}/pos")
                   for i in (0, 1))
    sc = jget_config("gemma2_2b").reduced().sliding_window
    off = []
    for t in sorted(tlog.segments):
        _, pos = tlog.segments[t]
        assert pos.tolist() == [t, t]        # every layer holds token t
        jseg = jlog.segments[t]
        assert int(np.asarray(jseg[glob])[0]) == t
        if int(np.asarray(jseg[local])[0]) != t:
            off.append(t)
    # the reference's clamp, on the tokens of a range crossing the wrap
    assert off and min(off) > sc - 8 and max(off) < sc + 8
    # two ranges of the live slot, one across the wrap, in one gather:
    # the store's bits, token by token
    r = teng.requests["wrap"]
    last = r.pos - 1                         # the ring holds the last Sc
    assert last - 15 < sc <= last - 7        # the first range wraps
    kv, pos = teng.layout.extract_ranges(teng.cache, [r.slot, r.slot],
                                         [last - 15, last - 7], [8, 8])
    toks = list(range(last - 15, last + 1))
    assert pos[:, 0].tolist() == toks
    for i, t in enumerate(toks):
        assert torch.equal(kv[i], tlog.segments[t][0])


def test_run_serving_stamps_every_token_of_a_segment():
    """``run_serving`` at seg 8 (``step_time`` 0.05, no failure) against
    the JAX loop at seg 8: every token of a segment is logged at its
    step's end, and the outputs, finish order, TTFTs and token log are
    equal; the outputs also equal the port's at seg 1."""
    from repro.data.workloads import make_workload as jmake_workload
    from repro.serving.scheduler import run_serving as jrun_serving
    from repro_torch.data.workloads import make_workload
    from repro_torch.serving.scheduler import run_serving
    base = dict(max_batch=8, max_seq=96, num_aw=2, num_ew=2)
    wl = dict(kind="sharegpt", rate_rps=12.0, duration=1.0, seed=0,
              max_prompt=40, max_new=16)
    jeng = JEngine(_cap4(jget_config("mixtral_8x7b").reduced()),
                   JEngineConfig(**base, decode_segment_len=8,
                                 telemetry=False, flight_recorder=False),
                   jax.random.PRNGKey(0))
    params = params_from_reference(jeng.params, device="cpu")
    jm = jrun_serving(jeng, jmake_workload(**wl), 600.0, step_time=0.05)
    got = {}
    for seg in (8, 1):
        eng = InferenceEngine(_cap4(tget_config("mixtral_8x7b").reduced()),
                              EngineConfig(**base, decode_segment_len=seg),
                              params=params, device="cpu")
        got[seg] = run_serving(eng, make_workload(**wl), 600.0,
                               step_time=0.05)
    m = got[8]
    assert m.outputs == jm.outputs and m.finished == jm.finished
    assert m.ttft == jm.ttft
    assert [(r.t, r.rid) for r in m.token_log] == \
        [(r.t, r.rid) for r in jm.token_log]
    assert len(m.token_log) == sum(len(v) for v in m.outputs.values())
    assert got[1].outputs == m.outputs
