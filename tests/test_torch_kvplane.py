"""The port's KV plane and AW failure domain against the JAX package, on
the reduced Mixtral (2 AWs x 2 EWs, 4 slots, float32, capacity factor 4 so
no token is ever dropped and a request's stream does not depend on its
slot or its chunking):

  * the paged + chunked engine gives the JAX engine's greedy streams, with
    and without an AW failure mid-run (``fail_aw(0)``, then
    ``recover_aw_requests``, one step, ``provision_aw(0)``);
  * inside the port, paged equals contiguous bit for bit (both chunked),
    and failover equals the failure-free run bit for bit;
  * a 1-token prompt is served on a paged engine, and a paged engine
    without chunked prefill is refused;
  * the PagePool keeps its invariants under seeded random operation
    sequences, alone and inside an engine with AW failures;
  * ``ops.decode_attention_paged`` agrees with the JAX op;
  * chunk and paged cache writes leave what the JAX writes drop untouched
    (padding, rows not in the call, blocks on the null page).
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.serving.api import RequestSpec as JSpec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.kvcache import PagePool

LENS = (12, 17, 9)
MAX_NEW = 8
FAIL_AT = 3        # mid-run: one request decoding, the others mid-prefill
ECFG = dict(max_batch=4, max_seq=64, num_aw=2, num_ew=2,
            chunk_token_budget=8)


def _cap4(cfg):
    # capacity >= tokens in every call: no token is dropped, so streams do
    # not depend on which slot or chunk a token rides
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))


def _prompts(vocab):
    # seed 7: every greedy choice along these streams wins by >= 1e-2
    r = np.random.default_rng(7)
    return [r.integers(1, vocab, size=(n,)).astype(np.int32) for n in LENS]


def _serve(engine, spec_cls, prompts, tag, fail_at=None):
    handles = [engine.client.submit(spec_cls(rid=f"{tag}{i}", prompt=p,
                                             max_new=MAX_NEW))
               for i, p in enumerate(prompts)]
    steps, restored = 0, None
    while not all(h.done() for h in handles):
        if fail_at is not None and steps == fail_at:
            engine.fail_aw(0)
            restored = engine.recover_aw_requests(now=float(engine.steps))
            engine.step()
            engine.provision_aw(0)
        engine.step()
        steps += 1
    out = [h.tokens() for h in handles]
    for h in reversed(handles):        # restore the slot free lists
        engine.release_request(h.rid)
    return out, restored


def _port_engine(params, **kw):
    return InferenceEngine(_cap4(tget_config("mixtral_8x7b").reduced()),
                           EngineConfig(**{**ECFG, **kw}), params=params,
                           device="cpu")


@pytest.fixture(scope="module")
def runs():
    jcfg = _cap4(jget_config("mixtral_8x7b").reduced())
    je = JEngine(jcfg, JEngineConfig(**ECFG, kv_page_tokens=16,
                                     telemetry=False, flight_recorder=False),
                 jax.random.PRNGKey(0))
    params = params_from_reference(je.params, device="cpu")
    paged = _port_engine(params, kv_page_tokens=16)
    contig = _port_engine(params)
    whole = _port_engine(params, chunk_token_budget=0)
    prompts = _prompts(jcfg.vocab_size)
    out = {"jax": _serve(je, JSpec, prompts, "a")[0],
           "jax_fail": _serve(je, JSpec, prompts, "f", FAIL_AT)[0],
           "paged": _serve(paged, RequestSpec, prompts, "a")[0],
           "contig": _serve(contig, RequestSpec, prompts, "a")[0],
           "whole": _serve(whole, RequestSpec, prompts, "a")[0]}
    out["paged_fail"], out["paged_restored"] = _serve(
        paged, RequestSpec, prompts, "f", FAIL_AT)
    out["contig_fail"], out["contig_restored"] = _serve(
        contig, RequestSpec, prompts, "f", FAIL_AT)
    # the reference's logits along its own streams, for the tie check
    fwd = jax.jit(je.api.forward_train)
    gaps = []
    for p, toks in zip(prompts, out["jax"]):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])[None]
        lg = np.asarray(fwd(je.params, {"tokens": jnp.asarray(seq)},
                            je.api.init_route_state())[0])[0]
        top2 = np.sort(lg[len(p) - 1:], axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
    out["min_gap"] = min(gaps)
    return out, paged, contig


def test_paged_chunked_streams_equal_reference(runs):
    out, _, _ = runs
    assert all(len(s) == MAX_NEW for s in out["jax"])
    # a mismatch is a fault, not a near-tie
    assert out["min_gap"] > 1e-3
    assert out["paged"] == out["jax"]


def test_streams_equal_reference_under_aw_failure(runs):
    out, paged, _ = runs
    assert out["jax_fail"] == out["jax"]
    assert out["paged_fail"] == out["jax_fail"]
    # AW1 had one free slot: one request restored at once, the other
    # waited at the front of the Gateway until AW0 was provisioned
    assert len(out["paged_restored"]) == 1
    assert paged.failed_aws == set() and paged.gateway.depth() == 0
    assert paged.chunked.stats.resumed >= 1


def test_paged_bitwise_contiguous_and_failover_bitwise_failure_free(runs):
    out, paged, contig = runs
    assert out["paged"] == out["contig"]
    # every prompt here is cut into chunks of at most 8 tokens, and on the
    # CPU the chunked streams are the whole-prompt ones bit for bit
    assert out["contig"] == out["whole"]
    assert out["paged_fail"] == out["paged"]
    assert out["contig_fail"] == out["contig"]
    assert out["paged_restored"] == out["contig_restored"]
    paged.pages.check()
    assert paged.pages.stats()["pages_used"] == 0
    assert paged.store.stats.restores == contig.store.stats.restores > 0


def test_one_token_prompt_on_paged_engine(runs):
    """A 1-token prompt takes the exact whole-prompt path; the port reads
    its prefill cache through the contiguous layout and scatters it into
    the slot's pages."""
    _, paged, contig = runs
    streams = []
    for eng in (paged, contig):
        h = eng.client.submit(RequestSpec(
            rid="one", prompt=np.array([5], np.int32), max_new=4))
        assert h.state() == "decoding" and len(h.tokens()) == 1
        while not h.done():
            eng.step()
        streams.append(h.tokens())
        eng.release_request("one")
    assert streams[0] == streams[1] and len(streams[0]) == 4
    paged.pages.check()


def test_lifecycle_states_on_paged_engine(runs):
    _, paged, _ = runs
    prompt = np.arange(1, 21, dtype=np.int32)
    h = paged.client.submit(RequestSpec(rid="life", prompt=prompt,
                                        max_new=2))
    assert h.state() == "prefilling"
    assert paged.chunked.outstanding_tokens() == 19
    aw = paged.requests["life"].aw
    paged.fail_aw(aw)
    assert h.state() == "preempted"
    assert paged.recover_aw_requests() == ["life"]    # onto the other AW
    paged.provision_aw(aw)
    assert h.state() == "prefilling" and paged.requests["life"].aw != aw
    paged.step()                                      # one 8-token chunk
    assert paged.chunked.outstanding_tokens() == 11
    while not h.done():
        paged.step()
    assert h.state() == "done" and len(h.tokens()) == 2
    paged.release_request("life")
    paged.pages.check()
    assert paged.pages.stats()["pages_used"] == 0


def test_paged_without_chunked_prefill_is_refused():
    cfg = tget_config("mixtral_8x7b").reduced()
    with pytest.raises(ValueError, match="chunked"):
        InferenceEngine(cfg, EngineConfig(max_batch=4, max_seq=64,
                                          kv_page_tokens=16), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        InferenceEngine(cfg, EngineConfig(max_batch=4, max_seq=64,
                                          kv_page_tokens=24,
                                          chunk_token_budget=8),
                        device="cpu")


# --------------------------------------------------------------------------
# allocator invariants under seeded random operation sequences
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 1234, 777777])
def test_pagepool_fuzz_never_leaks_or_double_frees(seed):
    """Random interleaved extend / pin / share / unpin / release sequences
    keep every allocator invariant (each page free exactly once XOR
    allocated, the block table only references live pages), and a full
    drain returns the pool to empty."""
    rng = random.Random(seed)
    num_slots, nblk = 4, 4
    pool = PagePool(num_slots, 2, nblk, 8)
    holders = []                      # extra references: lists of pages
    for _ in range(3000):
        op = rng.randrange(5)
        slot = rng.randrange(num_slots)
        aw = pool.aw_of_slot(slot)
        if op == 0:                   # extend: map one more block
            blk = pool.mapped_blocks(slot)
            if blk < nblk and pool.free_pages(aw):
                pool.map_block(slot, blk, pool.alloc(aw))
        elif op == 1:                 # pin a prefix of a slot's pages
            pages = pool.slot_pages(slot)
            if pages:
                k = rng.randrange(1, len(pages) + 1)
                for p in pages[:k]:
                    pool.incref(p)
                holders.append(list(pages[:k]))
        elif op == 2:                 # an empty slot maps pinned pages
            if holders and pool.mapped_blocks(slot) == 0:
                e = rng.choice(holders)
                for i, p in enumerate(e[:nblk]):
                    pool.incref(p)
                    pool.map_block(slot, i, p)
        elif op == 3:                 # unpin one page, tail first
            if holders:
                e = rng.choice(holders)
                if e:
                    pool.decref(e.pop())
                if not e:
                    holders.remove(e)
        else:                         # release / fail: unmap whole slot
            pool.release_slot(slot)
        pool.check()
    for s in range(num_slots):
        pool.release_slot(s)
    for e in holders:
        for p in e:
            pool.decref(p)
    pool.check()
    assert pool.stats() == {"pages_total": 16, "pages_used": 0,
                            "pages_shared": 0}


def test_paged_engine_fuzz_never_leaks(runs):
    """Engine level: submissions, chunk and decode steps, releases and AW
    fail / recover / provision cycles keep the pool's invariants after
    every operation; after a full drain every page is free and every free
    page is scrubbed."""
    _, paged, _ = runs
    rng = random.Random(99)
    r = np.random.default_rng(5)
    prompts = [r.integers(1, 200, size=(n,)).astype(np.int32)
               for n in (16, 22, 6, 30)]
    handles, counter = [], iter(range(10000))
    for _ in range(90):
        op = rng.random()
        if op < 0.3 and len(paged.requests) < 3:
            handles.append(paged.client.submit(RequestSpec(
                rid=f"z{next(counter)}", prompt=rng.choice(prompts),
                max_new=rng.randrange(2, 5))))
        elif op < 0.4:
            dead = sorted(paged.failed_aws)
            if dead:
                paged.provision_aw(dead[0])
            else:
                paged.fail_aw(rng.randrange(2))
                paged.recover_aw_requests(now=float(paged.steps))
        else:
            paged.step()
            for rid in [q.rid for q in paged.requests.values() if q.done]:
                paged.release_request(rid)
        paged.pages.check()
    for w in sorted(paged.failed_aws):
        paged.provision_aw(w)
    while not all(h.done() for h in handles):
        paged.step()
        for rid in [q.rid for q in paged.requests.values() if q.done]:
            paged.release_request(rid)
        paged.pages.check()
    assert not paged.requests and paged.gateway.depth() == 0
    assert paged.pages.stats()["pages_used"] == 0
    for layer in paged.cache["layers"]:
        assert bool((layer["pos"] == -1).all())


# --------------------------------------------------------------------------
# the paged decode-attention op
# --------------------------------------------------------------------------

def _paged_case(seed, b, h, hkv, dh, nblk, pt):
    """Pools with a null page 0, a page two rows share and unmapped tail
    blocks; positions causal in every row's gathered view."""
    r = np.random.default_rng(seed)
    f = np.float32
    npages = 1 + b * nblk
    pk = r.normal(size=(npages, pt, hkv, dh)).astype(f)
    pv = r.normal(size=(npages, pt, hkv, dh)).astype(f)
    q = r.normal(size=(b, h, dh)).astype(f)
    k1 = r.normal(size=(b, hkv, dh)).astype(f)
    v1 = r.normal(size=(b, hkv, dh)).astype(f)
    pos = r.integers(pt, nblk * pt, size=(b,)).astype(np.int32)
    ids = r.permutation(np.arange(1, npages)).astype(np.int32)
    bt = np.zeros((b, nblk), np.int32)
    for i in range(b):
        used = -(-int(pos[i]) // pt)
        bt[i, :used] = ids[i * nblk:i * nblk + used]
    bt[1, 0] = bt[0, 0]
    ppos = np.full((npages, pt), -1, np.int32)
    for i in range(b):
        for j in range(nblk):
            if bt[i, j]:
                ppos[bt[i, j]] = np.arange(j * pt, (j + 1) * pt)
    ppos[0] = -1
    return q, pk, pv, ppos, bt, k1, v1, pos


@pytest.mark.parametrize("b,h,hkv,dh", [(2, 8, 2, 64), (3, 4, 1, 32),
                                        (3, 16, 4, 128)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_attention_paged_op_matches_reference(b, h, hkv, dh,
                                                     softcap):
    args = _paged_case(b * 10 + h, b, h, hkv, dh, 4, 16)
    want = jops.decode_attention_paged(*[jnp.asarray(a) for a in args],
                                       softcap=softcap)
    t = [torch.from_numpy(a) for a in args]
    got = tops.decode_attention_paged(*t, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # bitwise the port's contiguous plain path on the gathered view
    q, pk, pv, ppos, bt, k1, v1, pos = t
    ck, cv, cpos = tda.gather_pages(pk, pv, ppos, bt)
    assert torch.equal(got, tda.decode_attention_plain(
        q, ck, cv, cpos, k1, v1, pos, softcap=softcap))


# --------------------------------------------------------------------------
# cache writes with the reference's drop semantics
# --------------------------------------------------------------------------

def _chunk_positions(r, b, c, sc):
    """Chunk-call positions as the chunked plane builds them: each row in
    the call holds one run of consecutive positions from column 0, then
    padding (-1); row 0 is not in the call."""
    pos = np.full((b, c), -1, np.int32)
    for i in range(1, b):
        take = int(r.integers(1, c + 1))
        start = int(r.integers(0, sc - take + 1))
        pos[i, :take] = np.arange(start, start + take)
    return pos


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_cache_write_chunk_drops_as_reference(seed, paged):
    """The same chunk write through the port and the JAX package: every
    entry the reference keeps lands bit for bit, and nothing it drops
    (padding, rows not in the call, blocks mapped to the null page)
    touches the cache. A paged decode write is the C = 1 case."""
    r = np.random.default_rng(seed)
    b, hkv, dh, pt, nblk = 4, 2, 8, 4, 6
    sc = pt * nblk
    for c in (5, 1):
        pos = _chunk_positions(r, b, c, sc)
        k = r.normal(size=(b, c, hkv, dh)).astype(np.float32)
        v = r.normal(size=(b, c, hkv, dh)).astype(np.float32)
        if paged:
            npages = 1 + b * nblk
            bt = np.zeros((b, nblk), np.int32)
            ids = r.permutation(np.arange(1, npages)).astype(np.int32)
            for i in range(b):       # half the blocks stay on the null page
                keep = r.random(nblk) < 0.5
                bt[i, keep] = ids[i * nblk:(i + 1) * nblk][keep]
            rows = npages
        else:
            rows = b
        ck = r.normal(size=(rows, pt if paged else sc, hkv, dh)).astype(
            np.float32)
        cv = r.normal(size=ck.shape).astype(np.float32)
        cpos = r.integers(-1, sc, size=ck.shape[:2]).astype(np.int32)
        if paged:
            cpos[0] = -1
            jc = jattn.paged_write_chunk(
                {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                 "pos": jnp.asarray(cpos)}, jnp.asarray(bt), k, v, pos)
            # the port's pools carry the sink page after the last
            tc = {n: torch.from_numpy(np.concatenate([a, a[:1]]))
                  for n, a in (("k", ck), ("v", cv), ("pos", cpos))}
            tattn.paged_write_chunk(tc, torch.from_numpy(bt),
                                    torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(pos))
            tc = {n: t[:-1] for n, t in tc.items()}
            assert (tc["pos"][0] == -1).all()
        else:
            jc = jattn.cache_write_chunk(
                {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                 "pos": jnp.asarray(cpos)}, k, v, pos)
            tc = {n: torch.from_numpy(a.copy())
                  for n, a in (("k", ck), ("v", cv), ("pos", cpos))}
            tattn.cache_write_chunk(tc, torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(pos))
        for n in ("k", "v", "pos"):
            assert np.array_equal(tc[n].numpy(), np.asarray(jc[n])), n
