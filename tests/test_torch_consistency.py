"""Consistency twins for the port, on the CPU:

  * ``tests/test_decode_consistency.py`` (its own twins are in
    ``tests/test_torch_train_twins.py``) in the serving batch's form: for
    every id of ``ARCH_IDS``, two requests prefilled alone decode in one
    call at their own positions, each equal to the port's own
    ``forward_train`` at its teacher-forced position (2e-4, the
    reference's bar); and the ring cache decoding past its window equal
    to the full-window mask;
  * ``tests/test_sampling.py`` on ``InferenceEngine.generate``: seed
    determinism, sampled against greedy, top-k 1, and the host
    ``sample_token`` shim: its distribution within a chi-square bound of
    the reference shim's on the same logits, and its counter
    reproducibility;
  * ``tests/test_batched_prefill.py``: the scheduler's prefill calls,
    batch sizes and streams against the JAX engine's;
  * ``tests/test_cache_layout.py``'s Appendix C size of an attention
    token segment, through the port's ``extract_tokens``;
  * the last entry points: ``generate``, ``choose_aw``,
    ``checkpointers``, ``api.LIFECYCLE_STATES`` and
    ``ert.ew_health_to_slot_health`` against the reference's.

The reference's weights come through ``repro_torch.convert``; greedy
streams are compared with the JAX engine's on the reduced Mixtral at
capacity factor 4.0.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import all_arch_ids, make_batch
from repro.configs import get_config as jget_config
from repro.core import ert as jert
from repro.models import get_model as jget_model
from repro.serving import api as japi
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.kvcache import CacheLayout as JCacheLayout
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core import ert as tert
from repro_torch.core.checkpoint import _seg_nbytes
from repro_torch.models import get_model as tget_model
from repro_torch.serving import api as tapi
from repro_torch.serving.api import RequestSpec, SamplingParams
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.kvcache import CacheLayout

TOL = dict(rtol=2e-4, atol=2e-4)        # test_decode_consistency.py's
PROMPT = np.arange(1, 9, dtype=np.int32)


def _model(arch, num_aw=2, num_ew=2, cap_factor=0.0, **replace):
    """The port's reduced model and the reference's params for it."""
    cfgs = []
    for cfg in (jget_config(arch).reduced(), tget_config(arch).reduced()):
        if cap_factor and cfg.moe.enabled:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cap_factor))
        cfgs.append(dataclasses.replace(cfg, **replace))
    jcfg, tcfg = cfgs
    jp = jget_model(jcfg, num_aw=num_aw, num_ew=num_ew).init_params(
        jax.random.PRNGKey(0))
    api = tget_model(tcfg, num_aw=num_aw, num_ew=num_ew, device="cpu")
    return api, params_from_reference(jp, device="cpu")


# --------------------------------------------------------------------------
# tests/test_decode_consistency.py
# --------------------------------------------------------------------------

def _prefill(api, params, toks, rs, max_seq, frames):
    kw = {} if frames is None else {"frames": torch.from_numpy(frames)}
    return api.prefill(params, torch.from_numpy(toks), rs, max_seq, **kw)


def _cat_rows(a, b):
    """Two caches of one row each as one cache of two rows (every leaf
    has the request row as axis 0)."""
    if isinstance(a, dict):
        return {k: _cat_rows(a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_cat_rows(x, y) for x, y in zip(a, b)]
    return torch.cat([a, b], 0)


@pytest.mark.parametrize("arch", all_arch_ids())
def test_decode_rows_at_different_positions_match_teacher_forcing(arch):
    """The serving batch's case of ``test_decode_consistency.py``: two
    requests prefilled alone (10 and 7 tokens) decode three steps in one
    call, each row at its own position, and each row's logits equal the
    port's own ``forward_train`` at that teacher-forced position (2e-4).
    The reference's form, both rows at one position, is
    ``tests/test_torch_train_twins.py::test_decode_matches_teacher_forcing``."""
    api, params = _model(arch, cap_factor=8.0)
    rs = api.init_route_state()
    lens = (10, 7)
    full = make_batch(api.cfg, 2, max(lens) + 3, np.random.default_rng(3))
    toks, frames = full["tokens"], full.get("frames")
    logits_full, _ = api.forward_train(params, full, rs)
    caches = []
    for row, n in enumerate(lens):
        last, cache, _ = _prefill(
            api, params, toks[row:row + 1, :n], rs, max(lens) + 4,
            None if frames is None else frames[row:row + 1])
        np.testing.assert_allclose(last.numpy(),
                                   logits_full[row:row + 1, n - 1].numpy(),
                                   **TOL)
        caches.append(cache)
    cache = _cat_rows(*caches)
    for j in range(3):
        pos = torch.tensor([n + j for n in lens], dtype=torch.int32)
        nxt = torch.from_numpy(np.array([toks[r, n + j]
                                         for r, n in enumerate(lens)]))
        lg, cache, _ = api.decode(params, nxt, pos, cache, rs)
        for row, n in enumerate(lens):
            np.testing.assert_allclose(
                lg[row].numpy(), logits_full[row, n + j].detach().numpy(),
                **TOL)


def test_sliding_window_ring_buffer_decodes_past_the_window():
    """Windowed decode with a ring cache == the full sequence with the
    window mask: past ``tests/test_torch_train_twins.py``'s prefill check,
    four decode steps that overwrite ring slots."""
    api, params = _model("h2o_danube_1_8b", num_aw=1, num_ew=1,
                         sliding_window=8)
    rs = api.init_route_state()
    s, extra = 12, 4
    batch = make_batch(api.cfg, 1, s + extra)
    toks = batch["tokens"]
    logits_full, _ = api.forward_train(params, batch, rs)
    last, cache, _ = _prefill(api, params, toks[:, :s], rs, 32, None)
    np.testing.assert_allclose(last.numpy(),
                               logits_full[:, s - 1].detach().numpy(), **TOL)
    # the cache is ring-sized (the window), not max_seq
    assert cache["layers"][0]["k"].shape[1] == 8
    for j in range(extra):
        pos = torch.full((1,), s + j, dtype=torch.int32)
        lg, cache, _ = api.decode(params, torch.from_numpy(toks[:, s + j]),
                                  pos, cache, rs)
        np.testing.assert_allclose(lg.numpy(),
                                   logits_full[:, s + j].detach().numpy(),
                                   **TOL)
    assert cache["layers"][0]["k"].shape[1] == 8


# --------------------------------------------------------------------------
# tests/test_sampling.py, on generate (the reference's engine: key 2)
# --------------------------------------------------------------------------

SAMPLING = dict(max_batch=4, max_seq=48, num_aw=2, num_ew=2)


def _mixtral(get_config):
    cfg = get_config("mixtral_8x7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))


def _jax_engine(key, **kw):
    return JEngine(_mixtral(jget_config), JEngineConfig(
        **kw, telemetry=False, flight_recorder=False),
        jax.random.PRNGKey(key))


@functools.lru_cache(maxsize=None)
def _params(key):
    return params_from_reference(jget_model(_mixtral(jget_config))
                                 .init_params(jax.random.PRNGKey(key)),
                                 device="cpu")


def _port_engine(key, **kw):
    return InferenceEngine(_mixtral(tget_config), EngineConfig(**kw),
                           params=_params(key), device="cpu")


def _sampled(**kw):
    return _port_engine(2, **SAMPLING, **kw)


@functools.lru_cache(maxsize=None)
def _greedy_reference():
    """The reference's greedy stream of PROMPT, 12 tokens."""
    return _jax_engine(2, **SAMPLING).generate("r", PROMPT, 12)


def test_sampled_decode_valid_and_seed_deterministic():
    kw = dict(greedy=False, temperature=0.8, top_k=8, sample_seed=5)
    a = _sampled(**kw).generate("r", PROMPT, 12)
    b = _sampled(**kw).generate("r", PROMPT, 12)
    assert a == b                       # same sample seed -> same stream
    vocab = _mixtral(tget_config).vocab_size
    assert len(a) == 12 and all(0 <= t < vocab for t in a)
    assert _sampled(**{**kw, "sample_seed": 6}).generate("r", PROMPT, 12) \
        != a


def test_sampling_differs_from_greedy():
    greedy = _sampled().generate("r", PROMPT, 12)
    assert greedy == _greedy_reference()
    hot = _sampled(greedy=False, temperature=5.0,
                   sample_seed=1).generate("r", PROMPT, 12)
    assert hot != greedy


def test_top_k_one_equals_greedy():
    k1 = _sampled(greedy=False, temperature=0.7, top_k=1,
                  sample_seed=9).generate("r", PROMPT, 10)
    assert k1 == _greedy_reference()[:10]


class _Ecfg:
    """What the reference's shim reads of its engine."""

    def __init__(self, **kw):
        self.ecfg = JEngineConfig(**SAMPLING, telemetry=False,
                                  flight_recorder=False, **kw)


# chi-square at 7 degrees of freedom (top-k 8), p = 0.001
CHI2_BOUND = 24.32


def test_sample_token_shim_distribution_equivalence():
    """The port's shim and the reference's draw from one distribution:
    on the same logits (top-k 8, temperature 0.7) the support is the
    top-k set in both, and over 4,000 draws each the two-sample
    chi-square statistic, and each one's against the exact
    probabilities, stay under the p = 0.001 bound at 7 degrees of
    freedom; each frequency is within the reference's 0.03."""
    kw = dict(greedy=False, temperature=0.7, top_k=8, sample_seed=0)
    eng = _sampled(**kw)
    ref = _Ecfg(**kw)
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal(64) * 3).astype(np.float32)
    scaled = logits.astype(np.float64) / 0.7
    kth = np.partition(scaled, -8)[-8]
    masked = np.where(scaled >= kth, scaled, -np.inf)
    p = np.exp(masked - masked.max())
    p /= p.sum()
    n = 4000
    port = np.bincount([eng.sample_token(logits, pos=i) for i in range(n)],
                       minlength=64)
    jref = np.bincount([JEngine.sample_token(ref, logits, pos=i)
                        for i in range(n)], minlength=64)
    sup = p > 0
    assert port[~sup].sum() == 0 and jref[~sup].sum() == 0
    assert (port[sup] > 0).all()
    both = port[sup] + jref[sup]
    chi2_two = float((((port[sup] - jref[sup]) ** 2) / both).sum())
    chi2_port = float((((port[sup] - n * p[sup]) ** 2) / (n * p[sup])).sum())
    chi2_ref = float((((jref[sup] - n * p[sup]) ** 2) / (n * p[sup])).sum())
    assert chi2_two < CHI2_BOUND, chi2_two
    assert chi2_port < CHI2_BOUND, chi2_port
    assert chi2_ref < CHI2_BOUND, chi2_ref
    assert np.abs(port / n - p).max() < 0.03


def test_sample_token_shim_counter_reproducible():
    """Same (seed, pos) => same draw; the shim holds no RNG state; a
    request's SamplingParams override the engine's; greedy is argmax."""
    eng = _sampled(greedy=False, temperature=0.9, top_k=6)
    rng = np.random.default_rng(8)
    logits = rng.standard_normal(48).astype(np.float32)
    a = [eng.sample_token(logits, seed=4, pos=p) for p in range(12)]
    b = [eng.sample_token(logits, seed=4, pos=p) for p in range(12)]
    assert a == b
    assert a != [eng.sample_token(logits, seed=5, pos=p) for p in range(12)]
    top6 = set(np.argsort(logits)[-6:].tolist())
    assert set(a) <= top6
    assert eng.sample_token(logits, SamplingParams(greedy=True)) == \
        int(np.argmax(logits))
    assert _sampled().sample_token(logits) == int(np.argmax(logits))


# --------------------------------------------------------------------------
# tests/test_batched_prefill.py (the reference's engine: key 0)
# --------------------------------------------------------------------------

BATCHED = dict(max_batch=8, max_seq=64, num_aw=2, num_ew=2)


def _prompts(lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, size=(n,)).astype(np.int32) for n in lens]


@functools.lru_cache(maxsize=None)
def _batched_jax():
    return _jax_engine(0, **BATCHED)


def _reset(eng):
    """The shared reference engine back in a fresh engine's state: no
    request, slot free lists in their first order, counters at zero."""
    for rid in list(eng.requests):
        eng.release_request(rid)
    assert eng.gateway.depth() == 0
    for w in eng.aws:
        w.slots.restore(set())
    for obj in (eng.gateway, eng.store, eng.scheduler):
        obj.stats = type(obj.stats)()
    eng.request_log, eng._release_hooks, eng._client = [], [], None
    eng.steps = 0
    return eng


def _both(scenario, fresh=False):
    """``scenario(engine, spec)`` on each package: the port on a fresh
    engine, the reference on one shared engine reset to a fresh one's
    state (compiled once), or with ``fresh`` (a scenario that fails a
    worker) on a fresh engine; returns (jax, port)."""
    je = _jax_engine(0, **BATCHED) if fresh else _reset(_batched_jax())
    return [scenario(je, japi.RequestSpec),
            scenario(_port_engine(0, **BATCHED), RequestSpec)]


def _prefill_stats(eng):
    st = eng.scheduler.stats
    return dict(calls=st.calls, requests=st.requests, rows=st.rows,
                real=st.real_tokens, padded=st.padded_tokens,
                batch_sizes=sorted(st.batch_sizes))


def _drain(eng):
    while eng.active_requests():
        eng.step()
    return {rid: list(r.tokens) for rid, r in eng.requests.items()}


def test_similar_lengths_share_one_prefill_call():
    def scenario(eng, spec):
        assert eng.prefill_paddable
        for i, p in enumerate(_prompts([6, 9, 12, 7, 15])):
            eng.gateway.enqueue(f"r{i}", p, 4, now=0.0)
        assert len(eng.scheduler.admit(0.0)) == 5
        st = _prefill_stats(eng)
        assert st["calls"] == 1 and st["batch_sizes"] == [5]
        assert 0.0 < eng.scheduler.stats.occupancy() <= 1.0
        return st, _drain(eng)
    j, t = _both(scenario)
    assert t == j
    assert all(len(v) == 4 for v in t[1].values())


def test_distinct_buckets_split_calls():
    def scenario(eng, spec):
        for i, p in enumerate(_prompts([5, 8, 20, 25])):
            eng.gateway.enqueue(f"r{i}", p, 4, now=0.0)
        eng.scheduler.admit(0.0)
        return _prefill_stats(eng)
    j, t = _both(scenario)
    assert t == j and t["calls"] == 2 and t["batch_sizes"] == [2, 2]


def test_batched_prefill_tokens_match_sequential():
    """Batch composition changes no stream: the prompts admitted together
    and one at a time through ``client.submit``."""
    ps = _prompts([6, 9, 12])

    def together(eng, spec):
        for i, p in enumerate(ps):
            eng.gateway.enqueue(f"r{i}", p, 6, now=0.0)
        eng.scheduler.admit(0.0)
        assert eng.scheduler.stats.calls == 1
        return _drain(eng)

    def one_by_one(eng, spec):          # the port's
        for i, p in enumerate(ps):
            eng.client.submit(spec(rid=f"r{i}", prompt=p, max_new=6))
            assert f"r{i}" in eng.requests
        assert eng.scheduler.stats.calls == 3
        return _drain(eng)
    jb, tb = _both(together)
    ts = one_by_one(_port_engine(0, **BATCHED), RequestSpec)
    assert tb == ts == jb


def test_max_new_one_completes_at_admission_exact_scheme():
    """A 1-token prompt takes the exact scheme (first token from the
    prefill logits); max_new 1 finishes at admission."""
    def scenario(eng, spec):
        eng.client.submit(spec(rid="r", prompt=np.asarray([5], np.int32),
                               max_new=1))
        r = eng.requests["r"]
        assert r.done and len(r.tokens) == 1
        assert eng.step() == {}
        return list(r.tokens)
    j, t = _both(scenario)
    assert t == j


def test_release_while_queued_for_recovery_cancels_cleanly():
    """Releasing a request that waits for recovery drops its Gateway
    entry; a later admission tick does not bring it back."""
    def scenario(eng, spec):
        ps = _prompts([7] * 8)
        for i in range(8):
            eng.client.submit(spec(rid=f"f{i}", prompt=ps[i], max_new=30))
        for _ in range(2):
            eng.step()
        on0 = sorted(r.rid for r in eng.requests.values() if r.aw == 0)
        on1 = [r.rid for r in eng.requests.values() if r.aw == 1]
        eng.fail_aw(0)
        assert eng.recover_aw_requests() == []
        assert eng.gateway.depth() == len(on0)
        eng.release_request(on0[0])
        assert eng.gateway.depth() == len(on0) - 1
        assert eng.scheduler.admit(0.0) == []
        eng.release_request(on1[0])
        assert eng.scheduler.admit(0.0) == [on0[1]]
        assert not eng.requests[on0[1]].paused
        out = eng.step()
        assert out
        return on0, on1, {k: list(v) for k, v in out.items()}
    j, t = _both(scenario, fresh=True)
    assert t == j


def test_non_paddable_arch_groups_exact_lengths():
    """A recurrent-state cache never sees pad tokens: equal lengths still
    share a call (the exact scheme), unequal ones split."""
    kw = dict(max_batch=4, max_seq=40, num_aw=2, num_ew=1)
    out = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            eng = JEngine(jget_config("xlstm_350m").reduced(), JEngineConfig(
                **kw, telemetry=False, flight_recorder=False),
                jax.random.PRNGKey(5))
            jparams = eng.params
        else:
            eng = InferenceEngine(tget_config("xlstm_350m").reduced(),
                                  EngineConfig(**kw),
                                  params=params_from_reference(
                                      jparams, device="cpu"), device="cpu")
        assert not eng.prefill_paddable
        for i, p in enumerate(_prompts([8, 8, 5])):
            eng.gateway.enqueue(f"r{i}", p, 3, now=0.0)
        eng.scheduler.admit(0.0)
        st = _prefill_stats(eng)
        assert st["calls"] == 2 and st["batch_sizes"] == [1, 2]
        toks = _drain(eng)
        assert all(len(v) == 3 for v in toks.values())
        out.append((st, toks))
    assert out[1] == out[0]


# --------------------------------------------------------------------------
# tests/test_cache_layout.py: a token segment's size (paper App. C)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_nbytes_matches_appendix_c(dtype):
    """An attention token segment is C = 2 * Hkv * head_dim * itemsize
    bytes a layer, plus one int32 position a layer; in float32 it is the
    reference's ``segment_nbytes`` to the byte."""
    cfg = dataclasses.replace(tget_config("qwen2_1_5b").reduced(),
                              dtype=dtype)
    api = tget_model(cfg, device="cpu")
    cache = api.init_cache(1, 8)
    kv, pos = CacheLayout().extract_tokens(cache, [0], [0])
    seg = [kv[0], pos[0]]
    itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
    per_layer = 2 * cfg.num_kv_heads * cfg.head_dim_ * itemsize
    assert kv[0].nbytes == cfg.num_layers * per_layer
    assert pos[0].nbytes == cfg.num_layers * 4
    assert _seg_nbytes(seg) == cfg.num_layers * (per_layer + 4)
    if dtype == "float32":
        jcfg = jget_config("qwen2_1_5b").reduced()
        japi_ = jget_model(jcfg)
        layout = JCacheLayout(japi_.init_cache)
        jseg = layout.token_segment(japi_.init_cache(1, 8), 0, 0)
        assert _seg_nbytes(seg) == layout.segment_nbytes(jseg,
                                                         attn_only=True)


# --------------------------------------------------------------------------
# the last entry points against the reference's
# --------------------------------------------------------------------------

def test_lifecycle_states_cover_every_handle_state():
    """The reference's order, and every state a port handle reports over
    queued, placed, prefilling, decoding, preempted, done and
    cancelled."""
    assert tapi.LIFECYCLE_STATES == japi.LIFECYCLE_STATES
    eng = _port_engine(0, max_batch=2, max_seq=64, num_aw=2, num_ew=2,
                       chunk_token_budget=8)
    long = np.arange(1, 33, dtype=np.int32)
    seen = set()
    hs = [eng.client.submit(RequestSpec(rid=f"r{i}", prompt=long,
                                        max_new=4)) for i in range(3)]
    hc = eng.client.submit(RequestSpec(rid="c", prompt=PROMPT, max_new=4))
    seen |= {h.state() for h in hs + [hc]}
    assert hc.cancel()
    seen.add(hc.state())
    n = 0
    while not all(h.done() for h in hs):
        if n == 6:
            eng.fail_aw(eng.requests["r0"].aw)
            eng.recover_aw_requests()
            eng.provision_aw(0)
            eng.provision_aw(1)
        seen |= {h.state() for h in hs}
        eng.step()
        for r in [r for r in eng.requests.values() if r.done]:
            eng.release_request(r.rid)
        n += 1
    seen |= {h.state() for h in hs}
    # whole-prompt prefill: placed until the first decode step
    whole = _port_engine(0, max_batch=2, max_seq=64, num_aw=2, num_ew=2)
    seen.add(whole.client.submit(RequestSpec(rid="w", prompt=PROMPT,
                                             max_new=2)).state())
    assert seen == set(tapi.LIFECYCLE_STATES)


def test_ew_health_to_slot_health_equals_reference():
    owner = np.array([0, 0, 1, 1, 2, 2, 0, 1, 2, 0], np.int32)
    for health in ([True, True, True], [False, True, True],
                   [True, False, False]):
        want = np.asarray(jert.ew_health_to_slot_health(
            jnp.asarray(health), owner))
        h = torch.tensor(health)
        for o in (owner, torch.from_numpy(owner)):
            got = tert.ew_health_to_slot_health(h, o)
            assert got.device == h.device and got.dtype == torch.bool
            assert got.numpy().tolist() == want.tolist()


def test_choose_aw_checkpointers_and_refused_generate():
    """``choose_aw`` follows the Gateway's pick as the reference's does
    after each admission; ``checkpointers`` maps each AW to its
    checkpointer; ``generate`` with every slot taken is refused and
    leaves nothing queued."""
    j = _jax_engine(0, max_batch=4, max_seq=48, num_aw=2, num_ew=2)
    t = _port_engine(0, max_batch=4, max_seq=48, num_aw=2, num_ew=2)
    picks = []
    for eng, spec in ((j, japi.RequestSpec), (t, RequestSpec)):
        got = [eng.choose_aw()]
        for i in range(4):
            eng.client.submit(spec(rid=f"f{i}", prompt=PROMPT, max_new=30))
            got.append(eng.choose_aw())
        picks.append(got)
        ck = eng.checkpointers
        assert sorted(ck) == [0, 1]
        assert [ck[a].aw_id for a in (0, 1)] == [0, 1]
        assert ck[0] is eng.aws[0].checkpointer
    assert picks[1] == picks[0] and picks[1][-1] is None
    with pytest.raises(AssertionError):
        j.generate("x", PROMPT, 4)
    with pytest.raises(RuntimeError, match="refused"):
        t.generate("x", PROMPT, 4)
    assert t.gateway.find("x") is None and "x" not in t.requests
    assert t.client.handle("x") is None
