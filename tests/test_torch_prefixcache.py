"""The port's prefix-cache plane (serving/prefixcache.py) against the JAX
package's: twins of the 14 tests of ``tests/test_prefixcache.py`` (the
paged plane's are in ``tests/test_torch_prefixcache_paged.py``).

Each scenario runs on both packages (the reduced Mixtral at capacity
factor 4, the reference tests' engine shapes; the port with the
reference's weights, converted) and holds the port's greedy streams and
``GatewayStats`` ``prefix_*`` counters equal to the reference's, then
applies the reference test's own checks to the port ("zero new jit
traces" reads "no new step graph": ``decode_plane.captures()``). The
cache-off runs the reference tests compare with run on the port only
(``cold``): the port's cache-on streams equal the reference's, which the
reference's own tests hold to its cache-off streams. The
radix index and the slot-level cache get seeded operation sequences
against the reference classes.

One rule of the port differs from the reference: a finished request's
cache entry stops at the positions its prefill computed (``len(prompt) -
1``). The last prompt token and the generated ones go through decode
steps, whose kernels round otherwise than the prefill and chunk kernels
on the card, so adopting their KV would not give the cold stream's bits.
The twins hold the port to the reference engine with that rule applied
(``capped_reference``, a wrapper around the reference's
``PrefixCachePlane.offer``); ``test_entries_stop_at_the_prefill_extent``
holds it to the unmodified reference: the same streams, each warm hit
one token shorter.
"""
import dataclasses
import functools
import random

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.checkpoint import CheckpointStore as JStore
from repro.data.workloads import make_workload as jmake_workload
from repro.serving.api import RequestSpec as JSpec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving import prefixcache as jprefixcache
from repro.serving.prefixcache import AWPrefixCache as JAWPrefixCache
from repro.serving.prefixcache import RadixIndex as JRadixIndex
from repro.serving.scheduler import run_serving as jrun_serving
from repro.serving.workers import AttentionWorker as JAttentionWorker
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core.checkpoint import CheckpointStore
from repro_torch.data.workloads import make_workload
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.prefixcache import AWPrefixCache, RadixIndex
from repro_torch.serving.scheduler import run_serving
from repro_torch.serving.workers import AttentionWorker

PKGS = ("jax", "port")
DEFAULTS = dict(max_batch=4, max_seq=64, num_aw=2, num_ew=2,
                chunk_token_budget=8, placement="session_affinity",
                prefix_cache_slots=2)
PREFIX_KEYS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
               "prefix_evictions", "prefix_restored", "prefix_global_hits",
               "prefix_migrated", "session_repins")


REFERENCE_OFFER = jprefixcache.PrefixCachePlane.offer


def _capped_offer(plane, r):
    """The reference's offer with the port's rule: a request's entry stops
    at its prefill-computed positions."""
    return REFERENCE_OFFER(plane, dataclasses.replace(
        r, pos=min(r.pos, len(r.prompt) - 1)))


@pytest.fixture(autouse=True)
def capped_reference(monkeypatch):
    monkeypatch.setattr(jprefixcache.PrefixCachePlane, "offer",
                        _capped_offer)


def _cfg(get_config):
    cfg = get_config("mixtral_8x7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))


@functools.lru_cache(maxsize=None)
def _port_params():
    je = JEngine(_cfg(jget_config), JEngineConfig(
        **DEFAULTS, flight_recorder=False), jax.random.PRNGKey(0))
    return params_from_reference(je.params, device="cpu")


def make_engine(pkg, **kw):
    """The reference tests' ``make_engine`` (PRNGKey(0) weights) in either
    package."""
    opts = {**DEFAULTS, **kw}
    if pkg == "jax":
        return JEngine(_cfg(jget_config),
                       JEngineConfig(**opts, flight_recorder=False),
                       jax.random.PRNGKey(0))
    return InferenceEngine(_cfg(tget_config), EngineConfig(**opts),
                           params=_port_params(), device="cpu")


def spec(eng, **kw):
    cls = RequestSpec if isinstance(eng, InferenceEngine) else JSpec
    return cls(**kw)


def captures(eng):
    """Decode traces (reference) or step graphs (port) so far."""
    if isinstance(eng, InferenceEngine):
        return eng.decode_plane.captures()
    return eng._decode._cache_size() + eng.decode_plane.segment_traces()


def run_to_done(eng, handles, release=True, max_steps=300):
    hs = handles if isinstance(handles, list) else [handles]
    n = 0
    while not all(h.done() for h in hs) and n < max_steps:
        eng.step()
        if release:
            for rid in [r.rid for r in eng.requests.values() if r.done]:
                eng.release_request(rid)
        n += 1
    assert all(h.done() for h in hs)
    if release:
        for rid in [r.rid for r in eng.requests.values() if r.done]:
            eng.release_request(rid)


def submit_run(eng, rid, prompt, max_new=4, session=None, release=True):
    h = eng.client.submit(spec(eng, rid=rid, prompt=prompt, max_new=max_new,
                               session=session))
    run_to_done(eng, h, release=release)
    return h.tokens()


def prompts(lens, seed=11, vocab=200):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=(n,)).astype(np.int32)
            for n in lens]


def prompts_chain(seed=11, lens=(24, 8, 6), vocab=200):
    """Multi-turn chat shape: each prompt extends the previous one."""
    rng = np.random.default_rng(seed)
    out, cur = [], np.zeros((0,), np.int32)
    for n in lens:
        cur = np.concatenate(
            [cur, rng.integers(1, vocab, size=(n,)).astype(np.int32)])
        out.append(cur)
    return out


def prefix_stats(eng):
    st = eng.gateway.stats
    return {k: getattr(st, k) for k in PREFIX_KEYS}


def cold(pkg, fn):
    """The cache-off comparison run, on the port only (None elsewhere)."""
    return fn() if pkg == "port" else None


def both(scenario):
    """``scenario(pkg)`` on each package; the results must be equal."""
    got = {pkg: scenario(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


# --------------------------------------------------------------------------
# the radix index and the slot-level cache against the reference classes
# --------------------------------------------------------------------------

def test_radix_insert_match_remove():
    idx = RadixIndex()
    idx.insert([1, 2, 3, 4], slot=0)
    idx.insert([1, 2, 9, 9], slot=1)
    idx.insert([7, 7], slot=2)
    usable = {0, 1, 2}
    assert idx.match([1, 2, 3, 4, 5, 6], usable) == (0, 4)
    assert idx.match([1, 2, 9, 9, 1], usable) == (1, 4)
    assert idx.match([1, 2, 3, 8], usable) == (0, 3)
    s, lcp = idx.match([1, 2, 5], usable)
    assert s in (0, 1) and lcp == 2
    assert idx.match([9, 9], usable) == (-1, 0)
    assert idx.match([1, 2, 3, 4], {1, 2}) == (1, 2)
    idx.remove([1, 2, 3, 4], slot=5)
    assert idx.exact_slot([1, 2, 3, 4]) == 0
    idx.remove([1, 2, 3, 4], slot=0)
    assert idx.exact_slot([1, 2, 3, 4]) == -1
    assert idx.match([1, 2, 3, 4], usable) == (1, 2)


@pytest.mark.parametrize("seed", range(4))
def test_radix_operation_sequence_matches_reference(seed):
    """Seeded inserts, removes and lookups over a small alphabet (many
    shared prefixes and edge splits): every answer equals the reference
    index's."""
    rng = random.Random(seed)
    ours, ref = RadixIndex(), JRadixIndex()
    live = []
    for _ in range(400):
        op = rng.random()
        toks = [rng.randrange(4) for _ in range(rng.randrange(1, 9))]
        if op < 0.35:
            slot = rng.randrange(12)
            ours.insert(toks, slot)
            ref.insert(toks, slot)
            live.append((toks, slot))
        elif op < 0.5 and live:
            t, slot = live.pop(rng.randrange(len(live)))
            ours.remove(t, slot)
            ref.remove(t, slot)
        elif op < 0.6:
            assert ours.exact_slot(toks) == ref.exact_slot(toks)
        else:
            usable = set(rng.sample(range(12), rng.randrange(13)))
            assert ours.match(toks, usable) == ref.match(toks, usable)


def test_aw_prefix_cache_budgets_and_lru():
    w = AttentionWorker(0, 0, 4, CheckpointStore())
    cache = AWPrefixCache(w.slots, max_slots=2, max_tokens=0)
    w.prefix_cache = cache
    sa, sb, sc = w.slots.alloc(), w.slots.alloc(), w.slots.alloc()
    assert cache.offer(sa, np.arange(1, 6), "ra", None, now=1.0)
    assert cache.offer(sb, np.arange(50, 60), "rb", None, now=2.0)
    assert cache.evictable_count() == 2
    free0 = w.slots.free_count()
    assert cache.offer(sc, np.arange(80, 88), "rc", None, now=3.0)
    assert cache.evictable_count() == 2
    assert w.slots.free_count() == free0 + 1
    assert cache.match_len(np.arange(1, 6)) == 0
    assert cache.match_len(np.arange(50, 60)) == 9
    tiny = AWPrefixCache(w.slots, max_slots=4, max_tokens=4)
    s = w.slots.alloc()
    assert not tiny.offer(s, np.arange(0, 9), "rx", None, now=0.0)


@pytest.mark.parametrize("seed", range(3))
def test_aw_prefix_cache_operation_sequence_matches_reference(seed):
    """Seeded take_slot / offer / forget_slot sequences under slot and
    token budgets: the same slots, hit lengths, offer answers, entries,
    free lists, evictions and released logs as the reference cache."""
    rng = random.Random(seed)

    def build(worker_cls, store_cls, cache_cls):
        released = []
        w = worker_cls(0, 0, 6, store_cls())
        stats = type("S", (), {"prefix_evictions": 0})()
        w.prefix_cache = cache_cls(w.slots, max_slots=3, max_tokens=40,
                                   min_match=3, release_log=released.append,
                                   stats=stats)
        return w, released, stats

    sides = [build(AttentionWorker, CheckpointStore, AWPrefixCache),
             build(JAttentionWorker, JStore, JAWPrefixCache)]
    held = []                      # slots of live admissions
    for step in range(300):
        op = rng.random()
        prompt = np.asarray([rng.randrange(3) + 1
                             for _ in range(rng.randrange(1, 14))], np.int32)
        if op < 0.45 and sides[0][0].free_slots() > 0:
            got = [w.take_slot(prompt, now=float(step)) for w, _, _ in sides]
            assert got[0] == got[1]
            held.append((got[0][0], prompt))
        elif op < 0.85 and held:
            slot, p = held.pop(rng.randrange(len(held)))
            toks = np.concatenate([p, np.asarray([rng.randrange(3) + 1],
                                                 np.int32)])
            ok = [w.prefix_cache.offer(slot, toks, f"r{step}", None,
                                       now=float(step))
                  for w, _, _ in sides]
            assert ok[0] == ok[1]
            if not ok[0]:
                for w, _, _ in sides:
                    w.slots.release(slot)
        elif held:
            slot, _ = held.pop(rng.randrange(len(held)))
            for w, _, _ in sides:
                w.prefix_cache.forget_slot(slot)
                w.slots.release(slot)
        (w0, rel0, st0), (w1, rel1, st1) = sides
        assert list(w0.slots._free) == list(w1.slots._free)
        assert rel0 == rel1 and st0.prefix_evictions == st1.prefix_evictions
        assert w0.prefix_cache.snapshot() == w1.prefix_cache.snapshot()
        assert {s: (e.tokens.tolist(), e.live, e.last_use)
                for s, e in w0.prefix_cache.entries.items()} == \
            {s: (e.tokens.tolist(), e.live, e.last_use)
             for s, e in w1.prefix_cache.entries.items()}


# --------------------------------------------------------------------------
# the planes' options
# --------------------------------------------------------------------------

PLANE_OPTIONS = ("prefix_cache_slots", "prefix_cache_tokens",
                 "prefix_min_match", "prefix_restore", "kv_pages",
                 "prefix_global_index", "prefix_migrate", "telemetry",
                 "stall_threshold", "hist_buckets_per_decade",
                 "trace_export_path")


def test_plane_options_default_as_the_reference():
    """Telemetry on, the prefix cache off: the reference's defaults."""
    ours, ref = EngineConfig(), JEngineConfig()
    assert {k: getattr(ours, k) for k in PLANE_OPTIONS} == \
        {k: getattr(ref, k) for k in PLANE_OPTIONS}
    assert ours.telemetry and not ours.prefix_cache_slots


@pytest.mark.parametrize("kw", [
    dict(chunk_token_budget=0),
    dict(prefix_global_index=True),
    dict(prefix_cache_slots=0, kv_page_tokens=16, prefix_migrate=True)])
def test_prefix_options_without_their_planes_are_refused(kw):
    """Where the reference asserts, the port raises ``ValueError``: the
    prefix cache needs chunked prefill, the global index and migration
    need paged KV and the prefix cache."""
    with pytest.raises(AssertionError):
        make_engine("jax", **kw)
    with pytest.raises(ValueError):
        make_engine("port", **kw)


# --------------------------------------------------------------------------
# bit-identity and hit accounting
# --------------------------------------------------------------------------

def test_warm_turn_bit_identical_and_counted():
    p1, tail = prompts([12, 7], seed=3)
    p2 = np.concatenate([p1, tail])

    def scenario(pkg):
        def off():
            eng = make_engine(pkg, prefix_cache_slots=0)
            return [submit_run(eng, "s-1", p1, session="sessA"),
                    submit_run(eng, "s-2", p2, session="sessA")]
        ref = cold(pkg, off)
        warm = make_engine(pkg)
        assert warm.prefix_plane is not None
        got = [submit_run(warm, "s-1", p1, session="sessA")]
        traces = captures(warm)
        got.append(submit_run(warm, "s-2", p2, session="sessA"))
        assert ref in (None, got)
        st = warm.gateway.stats
        assert st.prefix_hits == 1 and st.prefix_misses == 1
        assert st.prefix_hit_tokens == len(p1) - 1
        assert warm.chunked.stats.prefilled_tokens["s-2"] == \
            len(p2) - 1 - st.prefix_hit_tokens
        assert captures(warm) == traces
        assert warm.client.handle("s-2").status().prefix_hit == \
            st.prefix_hit_tokens
        return got, prefix_stats(warm)
    both(scenario)


def test_fully_cached_prompt_skips_prefill_entirely():
    p = prompts([16], seed=5)[0]

    def scenario(pkg):
        ref = cold(pkg, lambda: submit_run(
            make_engine(pkg, prefix_cache_slots=0), "r-1", p, session="s"))
        eng = make_engine(pkg)
        submit_run(eng, "r-1", p, session="s")
        got = submit_run(eng, "r-2", p, session="s")
        assert ref in (None, got)
        assert eng.gateway.stats.prefix_hit_tokens == len(p) - 1
        assert eng.chunked.stats.prefilled_tokens.get("r-2", 0) == 0
        return got, prefix_stats(eng)
    both(scenario)


def test_entries_stop_at_the_prefill_extent(monkeypatch):
    """Against the unmodified reference: a warm turn's hit stops one token
    short of the reference's (the donor's last prompt token went through a
    decode step), its tail prefill is one token longer, and the streams
    are the same."""
    monkeypatch.setattr(jprefixcache.PrefixCachePlane, "offer",
                        REFERENCE_OFFER)
    p1, tail = prompts([12, 7], seed=3)
    p2 = np.concatenate([p1, tail])

    def scenario(pkg):
        eng = make_engine(pkg)
        out = [submit_run(eng, "s-1", p1, session="sessA"),
               submit_run(eng, "s-2", p2, session="sessA")]
        entry = next(e for w in eng.aws if w.prefix_cache
                     for e in w.prefix_cache.entries.values())
        return out, eng.gateway.stats.prefix_hit_tokens, \
            eng.chunked.stats.prefilled_tokens["s-2"], entry.length
    port, ref = scenario("port"), scenario("jax")
    assert port[0] == ref[0]
    assert ref[1] == len(p1) and port[1] == len(p1) - 1
    assert port[2] == ref[2] + 1
    # the second turn's entry: its prompt's prefill extent, against the
    # reference's prompt and generated tokens
    assert port[3] == len(p2) - 1 and ref[3] == len(p2) + 3


def test_multi_turn_chat_bit_identical_vs_cache_disabled():
    def scenario(pkg):
        mk, serve = (jmake_workload, jrun_serving) if pkg == "jax" \
            else (make_workload, run_serving)
        wl = mk("multi_turn_chat", rate_rps=9.0, duration=1.0, seed=1,
                chat_turns=3, chat_turn_gap=0.4)
        assert len(wl) >= 6
        out = {}
        for slots in (0, 2) if pkg == "port" else (2,):
            eng = make_engine(pkg, max_batch=8, max_seq=96,
                              prefix_cache_slots=slots,
                              chunk_token_budget=16)
            m = serve(eng, wl, duration=300.0, step_time=0.02)
            assert len(m.finished) == len(wl)
            out[slots] = (m.outputs, m.gateway["prefix"])
        assert out[2][1]["hits"] > 0 and out[2][1]["hit_tokens"] > 0
        off = out.pop(0, None)
        if off is not None:
            assert off[0] == out[2][0] and off[1]["hits"] == 0
        return out
    both(scenario)


# --------------------------------------------------------------------------
# eviction under slot pressure, live-entry protection
# --------------------------------------------------------------------------

def test_full_cache_evicts_lru_to_admit_new_requests():
    olds = [np.arange(1 + 10 * i, 9 + 10 * i, dtype=np.int32)
            for i in range(4)]
    news = [np.arange(101 + 10 * i, 110 + 10 * i, dtype=np.int32)
            for i in range(2)]

    def scenario(pkg):
        eng = make_engine(pkg, num_aw=1, prefix_cache_slots=4)
        for i, p in enumerate(olds):
            submit_run(eng, f"old-{i}", p, session=f"o{i}")
        aw = eng.aws[0]
        assert len(aw.prefix_cache.entries) == 4
        assert aw.slots.free_count() == 0 and aw.free_slots() == 4
        outs = [submit_run(eng, f"new-{i}", p, session=f"n{i}")
                for i, p in enumerate(news)]

        def off():
            e = make_engine(pkg, num_aw=1, prefix_cache_slots=0)
            return [submit_run(e, f"new-{i}", p, session=f"n{i}")
                    for i, p in enumerate(news)]
        assert cold(pkg, off) in (None, outs)
        assert eng.gateway.stats.prefix_evictions >= 2
        assert eng.gateway.stats.prefix_hits == 0
        return outs, prefix_stats(eng)
    both(scenario)


def test_lru_order_respects_recency():
    pa = np.arange(1, 9, dtype=np.int32)
    pb = np.arange(50, 58, dtype=np.int32)
    pc = np.arange(150, 158, dtype=np.int32)

    def scenario(pkg):
        eng = make_engine(pkg, num_aw=1, max_batch=2, prefix_cache_slots=2)
        outs = [submit_run(eng, "a-1", pa, session="A"),
                submit_run(eng, "b-1", pb, session="B"),
                submit_run(eng, "a-2", np.concatenate(
                    [pa, np.arange(200, 204, dtype=np.int32)]), session="A"),
                submit_run(eng, "c-1", pc, session="C", release=False)]
        cache = eng.aws[0].prefix_cache
        assert cache.match_len(pa) > 0 and cache.match_len(pb) == 0
        assert any(e.session == "A" for e in cache.entries.values())
        return outs, prefix_stats(eng), sorted(
            (e.slot, e.tokens.tolist(), e.live)
            for e in cache.entries.values())
    both(scenario)


def test_live_prefixes_are_never_evicted():
    p = prompts([10], seed=6)[0]
    p2 = np.concatenate([p, prompts([5], seed=9)[0]])

    def scenario(pkg):
        eng = make_engine(pkg, num_aw=1, max_batch=2, prefix_cache_slots=2)
        submit_run(eng, "x-1", p, 2, session="X")
        h2 = eng.client.submit(spec(eng, rid="x-2", prompt=p2, max_new=30,
                                    session="X"))
        eng.step()
        assert eng.gateway.stats.prefix_hits == 1
        h3 = eng.client.submit(spec(eng, rid="y-1",
                                    prompt=prompts([6], seed=10)[0],
                                    max_new=30, session="Y"))
        eng.step()
        assert h3.state() in ("placed", "prefilling", "decoding")
        h4 = eng.client.submit(spec(eng, rid="z-1",
                                    prompt=prompts([6], seed=12)[0],
                                    max_new=2, session="Z"))
        assert h4.state() == "queued"
        live = [e for w in eng.aws if w.prefix_cache
                for e in w.prefix_cache.entries.values()]
        assert len(live) == 1 and live[0].live
        run_to_done(eng, [h2, h3, h4])
        return [h.tokens() for h in (h2, h3, h4)], prefix_stats(eng)
    both(scenario)


# --------------------------------------------------------------------------
# failure restoration and session re-pinning
# --------------------------------------------------------------------------

def test_aw_failure_restores_prefix_on_failover_aw():
    p1, tail = prompts([12, 6], seed=13)
    p2 = np.concatenate([p1, tail])

    def off():
        eng = make_engine("port", prefix_cache_slots=0)
        submit_run(eng, "s-1", p1, session="S")
        return submit_run(eng, "s-2", p2, session="S")

    def scenario(pkg):
        ref2 = cold(pkg, off)
        eng = make_engine(pkg)
        submit_run(eng, "s-1", p1, session="S")
        holders = [w.aw_id for w in eng.aws
                   if w.prefix_cache and w.prefix_cache.entries]
        assert len(holders) == 1
        traces = captures(eng)
        eng.fail_aw(holders[0])
        eng.recover_aw_requests(now=1.0)
        assert eng.gateway.stats.prefix_restored == 1
        assert captures(eng) == traces
        new_holders = [w.aw_id for w in eng.aws if w.alive and
                       w.prefix_cache and w.prefix_cache.entries]
        assert new_holders and new_holders[0] != holders[0]
        got = submit_run(eng, "s-2", p2, session="S")
        assert ref2 in (None, got)
        assert eng.gateway.stats.prefix_hits == 1
        assert eng.requests.get("s-2") is None
        assert eng.gateway.stats.session_repins == 1
        evs = [(e.t, e.kind, e.worker, e.detail)
               for e in eng.drain_request_events()]
        kinds = {e[1] for e in evs}
        assert "prefix_restored" in kinds and "session_repinned" in kinds
        assert captures(eng) == traces
        return got, prefix_stats(eng), evs, holders, new_holders
    both(scenario)


def test_prefix_restore_disabled_drops_orphans():
    p = prompts([10], seed=14)[0]

    def scenario(pkg):
        eng = make_engine(pkg, prefix_restore=False)
        submit_run(eng, "s-1", p, session="S")
        holder = next(w.aw_id for w in eng.aws
                      if w.prefix_cache and w.prefix_cache.entries)
        eng.fail_aw(holder)
        eng.recover_aw_requests(now=1.0)
        assert eng.gateway.stats.prefix_restored == 0
        assert all(not w.prefix_cache.entries for w in eng.aws
                   if w.prefix_cache is not None)
        assert eng.store._logs == {}
        return holder, prefix_stats(eng)
    both(scenario)


def test_session_repin_points_future_turns_at_healthy_aw():
    p = prompts([8], seed=15)[0]

    def scenario(pkg):
        eng = make_engine(pkg, prefix_cache_slots=0)
        out = [submit_run(eng, "t-1", p, 2, session="T")]
        pol = eng.gateway.policy
        home = pol.pins["T"]
        eng.fail_aw(home)
        h = eng.client.submit(spec(eng, rid="t-2", prompt=p, max_new=2,
                                   session="T"))
        run_to_done(eng, h)
        out.append(h.tokens())
        assert pol.pins["T"] != home
        assert eng.gateway.stats.session_repins == 1
        evs = [(e.kind, e.worker, e.detail)
               for e in eng.drain_request_events()]
        assert any(e[0] == "session_repinned" for e in evs)
        return out, evs, prefix_stats(eng)
    both(scenario)


def test_recovery_entry_resumes_with_prefix_hit_intact():
    p1, tail = prompts([12, 20], seed=16)
    p2 = np.concatenate([p1, tail])

    def off():
        eng = make_engine("port", prefix_cache_slots=0)
        submit_run(eng, "s-1", p1, session="S")
        return submit_run(eng, "s-2", p2, session="S")

    def scenario(pkg):
        ref2 = cold(pkg, off)
        eng = make_engine(pkg)
        submit_run(eng, "s-1", p1, session="S")
        h = eng.client.submit(spec(eng, rid="s-2", prompt=p2, max_new=4,
                                   session="S"))
        r = eng.requests["s-2"]
        hit = r.prefill_cursor
        assert hit >= len(p1) - 1
        eng.step()
        assert r.prefilling
        eng.fail_aw(r.aw)
        eng.recover_aw_requests(now=1.0)
        cursor = r.prefill_cursor
        assert cursor >= hit
        run_to_done(eng, h)
        assert ref2 in (None, h.tokens())
        pre = eng.chunked.stats.prefilled_tokens["s-2"]
        assert pre <= len(p2) - 1 - hit
        return h.tokens(), hit, cursor, pre, prefix_stats(eng)
    both(scenario)


def test_cancelled_adopter_forgets_the_live_entry():
    p = prompts([10], seed=17)[0]
    p2 = np.concatenate([p, prompts([6], seed=18)[0]])

    def scenario(pkg):
        eng = make_engine(pkg, num_aw=1, max_batch=2)
        submit_run(eng, "c-1", p, 2, session="C")
        h = eng.client.submit(spec(eng, rid="c-2", prompt=p2, max_new=20,
                                   session="C"))
        eng.step()
        assert eng.gateway.stats.prefix_hits == 1
        assert h.cancel()
        assert not eng.aws[0].prefix_cache.entries
        assert eng.aws[0].slots.free_count() == 2
        got = submit_run(eng, "d-1", p2, 3, session="D")
        assert cold(pkg, lambda: submit_run(
            make_engine(pkg, num_aw=1, max_batch=2, prefix_cache_slots=0),
            "d-1", p2, 3, session="D")) in (None, got)
        return got, prefix_stats(eng)
    both(scenario)


def test_rid_reuse_does_not_corrupt_cached_log():
    p = prompts([10], seed=20)[0]
    p2 = np.concatenate([p, prompts([6], seed=21)[0]])

    def off():
        eng = make_engine("port", prefix_cache_slots=0)
        submit_run(eng, "r", p, 3, session="S")
        return submit_run(eng, "r", p2, 8, session="S")

    def scenario(pkg):
        ref2 = cold(pkg, off)
        eng = make_engine(pkg)
        submit_run(eng, "r", p, 3, session="S")
        h = eng.client.submit(spec(eng, rid="r", prompt=p2, max_new=8,
                                   session="S"))
        assert eng.gateway.stats.prefix_hits == 1
        for _ in range(2):
            eng.step()
        eng.fail_aw(eng.requests["r"].aw)
        eng.recover_aw_requests(now=1.0)
        run_to_done(eng, h)
        assert ref2 in (None, h.tokens())
        return h.tokens(), prefix_stats(eng), sorted(eng.store._logs)
    both(scenario)
