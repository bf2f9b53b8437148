"""The port's paged prefix-cache plane against the JAX package's: twins
of the paged-plane cases of ``tests/test_paged_kv.py`` (warm turns paged
== contiguous, the global index, migration, exclusive-page pricing), a
page budget below parity, and ``tests/test_device_decode.py``'s warm turn
at seg 8, on the helpers and the reference rule of
``tests/test_torch_prefixcache.py`` (the reference runs with the port's
rule: an entry stops at its prefill-computed positions). A paged
adopt/evict fuzz holds ``PagePool.check()`` after every operation.
"""
import random

import numpy as np
import pytest

from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.serving.api import RequestSpec, SamplingParams
from test_torch_prefixcache import (both, capped_reference, cold,  # noqa: F401
                                    make_engine, prefix_stats, prompts,
                                    prompts_chain, run_to_done, spec,
                                    submit_run)


# --------------------------------------------------------------------------
# the paged plane: shared pages, the global index, migration, eviction
# --------------------------------------------------------------------------

def _warm_turns(pkg, **kw):
    eng = make_engine(pkg, checkpoint=True, **kw)
    out = [submit_run(eng, f"sess-{i}", p, session="sess")
           for i, p in enumerate(prompts_chain())]
    return eng, out


def test_paged_matches_contiguous_warm_turns():
    def contiguous():
        ceng, want = _warm_turns("port")
        return want, (ceng.gateway.stats.prefix_hits,
                      ceng.gateway.stats.prefix_hit_tokens)

    def scenario(pkg):
        peng, got = _warm_turns(pkg, kv_page_tokens=16)
        assert cold(pkg, contiguous) in (None, (got, (
            peng.gateway.stats.prefix_hits,
            peng.gateway.stats.prefix_hit_tokens)))
        assert prefix_stats(peng)["prefix_hits"] > 0
        peng.pages.check()
        assert peng.pages.stats()["pages_shared"] > 0
        return got, prefix_stats(peng), peng.pages.stats()
    both(scenario)


def test_global_index_routes_new_session_to_cached_aw():
    chain = prompts_chain()

    def scenario(pkg):
        results = {}
        modes = [("paged", dict(kv_page_tokens=16,
                                prefix_global_index=True))]
        if pkg == "port":
            modes.append(("contig", {}))
        for mode, kw in modes:
            eng = make_engine(pkg, checkpoint=True, **kw)
            t1 = submit_run(eng, "alpha-0", chain[0], session="alpha")
            t2 = submit_run(eng, "beta-0", chain[1], session="beta")
            results[mode] = (t1, t2, prefix_stats(eng))
            if eng.pages is not None:
                assert eng.gateway.stats.prefix_global_hits >= 1
                assert eng.gateway.stats.prefix_hits >= 1
                eng.pages.check()
        contig = results.pop("contig", None)
        assert contig is None or contig[:2] == results["paged"][:2]
        return results
    both(scenario)


def test_prefix_migration_follows_demand():
    chain = prompts_chain()

    def scenario(pkg):
        want = cold(pkg, lambda: [
            submit_run(make_engine(pkg, checkpoint=True), f"w{i}", p,
                       session=f"w{i}") for i, p in enumerate(chain[:2])])
        eng = make_engine(pkg, checkpoint=True, kv_page_tokens=16,
                          prefix_global_index=True, prefix_migrate=True)
        t1 = submit_run(eng, "alpha-0", chain[0], session="alpha")
        home = eng.prefix_plane.global_index.match(chain[1])[1]
        held = [eng.aws[home].slots.alloc()
                for _ in range(eng.aws[home].slots.free_count())]
        t2 = submit_run(eng, "beta-0", chain[1], session="beta")
        for s in held:
            eng.aws[home].slots.release(s)
        assert want in (None, [t1, t2])
        st = eng.gateway.stats
        assert st.prefix_migrated == 1 and st.prefix_global_hits >= 1
        assert st.prefix_hits >= 1
        new_home = eng.prefix_plane.global_index.match(chain[1])[1]
        assert new_home != home
        eng.pages.check()
        return [t1, t2], prefix_stats(eng), home, new_home
    both(scenario)


def test_paged_eviction_prices_exclusive_pages():
    chain = prompts_chain(seed=3, lens=(10, 6))

    def scenario(pkg):
        eng = make_engine(pkg, checkpoint=True, kv_page_tokens=8,
                          max_batch=2, num_aw=1, max_seq=32)
        pool = eng.pages
        cache = eng.aws[0].prefix_cache
        outs = [submit_run(eng, "s-0", chain[0], session="s"),
                submit_run(eng, "s-1", chain[1], session="s")]
        assert len(cache.entries) >= 1
        shared = [p for e in cache.entries.values() for p in e.pages
                  if pool.ref[p] > 1]
        before = {p: int(pool.ref[p]) for p in shared}
        held = []
        while pool.free_pages(0):
            held.append(pool.alloc(0))
        freed = cache.evict_pages()
        assert freed, "eviction could not free a page"
        for p in freed:
            assert pool.ref[p] == 0 and p not in before
        for p in held:
            pool.decref(p)
        pool.check()
        return outs, freed, before, prefix_stats(eng)
    both(scenario)


def test_page_budget_below_parity_trims_tails_and_stays_bitwise():
    """``kv_pages`` at half the contiguous footprint: admissions reclaim
    cached tail pages (``_trim_tail``); the streams stay the contiguous
    engine's and no page leaks, as in the reference."""
    chain = prompts_chain(seed=5, lens=(20, 9, 7, 11))

    def scenario(pkg):
        want = cold(pkg, lambda: [
            submit_run(make_engine(pkg, checkpoint=True), f"c{i}", p,
                       session="s") for i, p in enumerate(chain)])
        eng = make_engine(pkg, checkpoint=True, kv_page_tokens=8,
                          kv_pages=8)
        got = []
        for i, p in enumerate(chain):
            got.append(submit_run(eng, f"c{i}", p, session="s"))
            eng.pages.check()
        assert want in (None, got)
        assert eng.gateway.stats.prefix_evictions > 0
        return got, prefix_stats(eng), eng.pages.stats()
    both(scenario)


# --------------------------------------------------------------------------
# the paged adopt/evict fuzz: PagePool invariants after every operation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(2))
def test_paged_adopt_evict_fuzz_keeps_pool_invariants(seed):
    """Seeded interleavings of warm and cold admissions, early releases,
    cancels, page-pressure eviction and AW failures on a paged engine with
    a tight page budget: ``PagePool.check()`` holds after every step, no
    page with refcount > 1 is ever freed, and every page returns once the
    engine is drained."""
    rng = random.Random(seed)
    eng = make_engine("port", checkpoint=True, kv_page_tokens=8,
                      kv_pages=14, prefix_cache_tokens=64,
                      prefix_global_index=True, prefix_migrate=True)
    pool = eng.pages
    freed_shared = []
    decref = pool.decref

    def checked_decref(pid):
        before = int(pool.ref[pid])
        out = decref(pid)
        if out and before > 1:
            freed_shared.append(pid)
        return out
    pool.decref = checked_decref
    base = prompts_chain(seed=seed, lens=(12, 6, 5, 9))
    handles = {}
    for step in range(60):
        op = rng.random()
        live = [h for h in handles.values() if not h.done()]
        if op < 0.45 and len(live) < 3:
            i = len(handles)
            p = base[rng.randrange(len(base))]
            if rng.random() < 0.3:
                p = np.concatenate([p, prompts([3], seed=i)[0]])
            handles[f"f{i}"] = eng.client.submit(RequestSpec(
                rid=f"f{i}", prompt=p, max_new=rng.randrange(1, 6),
                session=f"s{rng.randrange(3)}"))
        elif op < 0.5 and live:
            live[rng.randrange(len(live))].cancel()
        elif op < 0.53 and all(w.alive for w in eng.aws):
            aw = rng.randrange(2)
            eng.fail_aw(aw)
            eng.recover_aw_requests(now=float(eng.steps))
            eng.provision_aw(aw)
        eng.step()
        for rid in [r.rid for r in eng.requests.values() if r.done]:
            eng.release_request(rid)
        pool.check()
    while eng.requests or eng.gateway.depth():
        eng.step()
        for rid in [r.rid for r in eng.requests.values() if r.done]:
            eng.release_request(rid)
    pool.check()
    assert not freed_shared
    for w in eng.aws:
        for eid in list(w.prefix_cache.entries):
            eng._kv_free_pages(w.prefix_cache.remove_entry(eid))
    pool.check()
    assert pool.stats()["pages_used"] == 0


# --------------------------------------------------------------------------
# decode segments on a warm turn
# --------------------------------------------------------------------------

def test_segment_prefix_cache_warm_turn_bit_identical():
    """The second turn rides a prefix hit; seg 8 equals seg 1 (stochastic
    sampling inside the port, whose sampler hash is its own) and the
    greedy seg-8 streams equal the reference's."""
    p1 = np.arange(1, 17, dtype=np.int32)
    p2 = np.concatenate([p1, np.asarray([3, 1], np.int32)])

    def turns(pkg, seg, sampling=None):
        eng = make_engine(pkg, decode_segment_len=seg)
        extra = {} if sampling is None else {"sampling": sampling}
        h1 = eng.client.submit(spec(eng, rid="t1", prompt=p1, max_new=6,
                                    session="s", **extra))
        run_to_done(eng, h1)
        h2 = eng.client.submit(spec(eng, rid="t2", prompt=p2, max_new=12,
                                    session="s", **extra))
        run_to_done(eng, h2)
        return h1.tokens(), h2.tokens(), eng.gateway.stats.prefix_hits

    stoch = SamplingParams(greedy=False, temperature=1.1, top_k=12, seed=5)
    t1_seg, t2_seg, hits_seg = turns("port", 8, stoch)
    t1_ref, t2_ref, hits_ref = turns("port", 1, stoch)
    assert hits_seg >= 1 and hits_ref >= 1
    assert (t1_seg, t2_seg) == (t1_ref, t2_ref)
    assert turns("port", 8) == turns("jax", 8)
