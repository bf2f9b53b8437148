"""The port's serving engine against the JAX InferenceEngine on the
quickstart's reduced Mixtral (2 AWs x 2 EWs, capacity factor 4): the same
requests through ``client.submit`` give equal greedy streams, with and
without ``fail_ew(0)`` mid-decode. Telemetry, flight recorder and
checkpointing are off in the reference: they are bit-identical on or off
there, and this slice does not port them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.serving.api import RequestSpec as JSpec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.serving.api import RequestSpec, SamplingParams
from repro_torch.serving.decode_loop import _sample_tokens
from repro_torch.serving.engine import EngineConfig, InferenceEngine

MAX_NEW = 16
PROMPT_LENS = (8, 13, 1, 20, 8)        # padded buckets 16/32 and one exact


def _quickstart(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))


def _serve(engine, spec_cls, prompts, tag, fail_at=None):
    handles = [engine.client.submit(spec_cls(rid=f"{tag}{i}", prompt=p,
                                             max_new=MAX_NEW))
               for i, p in enumerate(prompts)]
    steps = 0
    while not all(h.done() for h in handles):
        if fail_at is not None and steps == fail_at:
            engine.fail_ew(0)
        engine.step()
        steps += 1
    out = [h.tokens() for h in handles]
    for h in reversed(handles):        # restore the slot free lists
        engine.release_request(h.rid)
    return out


@pytest.fixture(scope="module")
def runs():
    jcfg = _quickstart(jget_config("mixtral_8x7b").reduced())
    tcfg = _quickstart(tget_config("mixtral_8x7b").reduced())
    je = JEngine(jcfg, JEngineConfig(
        max_batch=8, max_seq=96, num_aw=2, num_ew=2, checkpoint=False,
        telemetry=False, flight_recorder=False), jax.random.PRNGKey(0))
    te = InferenceEngine(tcfg, EngineConfig(max_batch=8, max_seq=96,
                                            num_aw=2, num_ew=2),
                         params=params_from_reference(je.params,
                                                        device="cpu"),
                         device="cpu")
    # seed 4: every greedy choice along these streams wins by >= 3e-3
    r = np.random.default_rng(4)
    prompts = [r.integers(1, jcfg.vocab_size, size=(n,)).astype(np.int32)
               for n in PROMPT_LENS]
    out = {"jax": _serve(je, JSpec, prompts, "a"),
           "port": _serve(te, RequestSpec, prompts, "a"),
           "jax_fail": _serve(je, JSpec, prompts, "f", fail_at=4),
           "port_fail": _serve(te, RequestSpec, prompts, "f", fail_at=4)}
    # the reference's logits along its own streams, for the tie check
    fwd = jax.jit(je.api.forward_train)
    gaps = []
    for p, toks in zip(prompts, out["jax"]):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])[None]
        lg = np.asarray(fwd(je.params, {"tokens": jnp.asarray(seq)},
                            je.api.init_route_state())[0])[0]
        top2 = np.sort(lg[len(p) - 1:], axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        assert list(lg[len(p) - 1:].argmax(-1)) == list(toks)
    out["min_gap"] = min(gaps)
    return out, te, tcfg


def test_greedy_streams_equal_reference(runs):
    out, _, _ = runs
    assert all(len(s) == MAX_NEW for s in out["jax"])
    # a mismatch is a fault, not a near-tie: every greedy choice of the
    # reference wins by far more than the 1e-4 logit tolerance
    assert out["min_gap"] > 1e-3
    assert out["port"] == out["jax"]


def test_streams_equal_under_ew_failure(runs):
    out, te, _ = runs
    assert out["port_fail"] == out["jax_fail"]
    assert out["port_fail"] == out["port"]
    assert te.failed_ews == {0}
    te.provision_ew(0)
    assert te.failed_ews == set()


def test_client_lifecycle(runs):
    _, te, cfg = runs
    prompt = np.arange(1, 10, dtype=np.int32)
    h = te.client.submit(RequestSpec(rid="life", prompt=prompt, max_new=3))
    assert h.state() == "placed"
    assert h.new_tokens() == []
    te.step()
    assert h.state() == "decoding" and len(h.new_tokens()) == 1
    while not h.done():
        te.step()
    assert h.status().tokens_generated == 3 and len(h.new_tokens()) == 2
    te.release_request("life")
    assert h.state() == "done" and len(h.tokens()) == 3
    c = te.client.submit(RequestSpec(rid="gone", prompt=prompt, max_new=8))
    assert c.cancel() and c.state() == "cancelled"
    with pytest.raises(ValueError):
        RequestSpec(prompt=prompt, slo_class="bulk")
    # lazy prompts draw as the reference's workload generator does
    lazy = RequestSpec(prompt_len=6, seed=3)
    assert list(lazy.resolve_prompt(cfg.vocab_size)) == list(
        JSpec(prompt_len=6, seed=3).resolve_prompt(cfg.vocab_size))


def test_sampled_streams_ignore_slot_and_batch(runs):
    """The port's counter-based draw depends on (engine seed, request
    seed, position) only: a sampled request gives the same stream alone
    and among co-residents, in whichever slot it lands."""
    _, te, _ = runs
    prompt = np.arange(3, 15, dtype=np.int32)
    sp = SamplingParams(greedy=False, temperature=0.8, top_k=20, seed=7)

    def stream(n_before):
        others = [te.client.submit(RequestSpec(
            rid=f"o{i}", prompt=prompt[::-1].copy(), max_new=4))
            for i in range(n_before)]
        h = te.client.submit(RequestSpec(rid="s", prompt=prompt, max_new=6,
                                          sampling=sp))
        while not h.done():
            te.step()
        toks = h.tokens()
        for o in others:
            while not o.done():
                te.step()
            te.release_request(o.rid)
        te.release_request("s")
        return toks

    alone = stream(0)
    assert stream(3) == alone


def test_sampler_greedy_first_max_and_top_k():
    lg = torch.tensor([[1.0, 3.0, 3.0, 0.0], [0.5, 0.1, 0.2, 0.9]])
    pos = torch.tensor([4, 4], dtype=torch.int32)
    greedy = torch.tensor([True, False])
    toks = _sample_tokens(0, lg, pos, greedy, torch.tensor([1.0, 1.0]),
                          torch.tensor([0, 1], dtype=torch.int32),
                          torch.tensor([1, 2]), deep_k=False)
    assert toks.tolist() == [1, 3]        # first max; top-1 keeps index 3


@pytest.mark.parametrize("policy", ["least_loaded", "round_robin"])
def test_gateway_admission_order_matches_reference(policy):
    """Class queues, weighted dequeue, deadline order and placement give
    the reference's (rid, AW, slot) admissions on a pool too small for
    the queue."""
    from repro.core.checkpoint import CheckpointStore
    from repro.serving.gateway import Gateway as JGateway
    from repro.serving.workers import AttentionWorker as JAW
    from repro_torch.core.checkpoint import CheckpointStore as TStore
    from repro_torch.serving.gateway import Gateway
    from repro_torch.serving.workers import AttentionWorker

    store = CheckpointStore()
    jg = JGateway([JAW(a, 2 * a, 2 * a + 2, store) for a in range(2)],
                  policy=policy)
    tstore = TStore()
    tg = Gateway([AttentionWorker(a, 2 * a, 2 * a + 2, tstore)
                  for a in range(2)], policy=policy)
    reqs = [("b0", "batch", None), ("s0", "standard", None),
            ("i0", "interactive", 5.0), ("s1", "standard", 2.0),
            ("i1", "interactive", 1.0), ("b1", "batch", None),
            ("s2", "standard", None)]
    for g in (jg, tg):
        for rid, cls, dl in reqs:
            g.enqueue(rid, np.arange(4), 4, slo_class=cls, deadline=dl)
    want = [(q.rid, aw, slot) for q, aw, slot in jg.admit()]
    got = [(q.rid, aw, slot) for q, aw, slot in tg.admit()]
    assert got == want and len(got) == 4
    assert [e.rid for e in tg.queue] == \
        [e.rid for e in jg.queue]


def test_provision_aw_frees_each_slot_once():
    """A request that finished on AW0 and is not yet released keeps its
    slot through ``fail_aw(0)``, recovery, a step and ``provision_aw(0)``;
    its release then frees the slot once. AW0's free list holds each slot
    once, and the next two admissions there get different slots. (The
    reference re-provisions with the slots of ``active_requests()``, which
    leaves the finished request out, and lists its slot twice.)"""
    cfg = _quickstart(tget_config("mixtral_8x7b").reduced())
    te = InferenceEngine(cfg, EngineConfig(max_batch=4, max_seq=32,
                                           num_aw=2, num_ew=2),
                         device="cpu")
    prompt = np.arange(1, 7, dtype=np.int32)
    h = te.client.submit(RequestSpec(rid="done0", prompt=prompt, max_new=2))
    aw0, slot = te.requests["done0"]._aw, te.requests["done0"].slot
    while not h.done():
        te.step()
    te.fail_aw(aw0)
    busy = [te.client.submit(RequestSpec(rid=f"busy{i}", prompt=prompt,
                                          max_new=24))
            for i in range(2)]           # AW1 full: the next go to AW0
    assert {te.requests[b.rid]._aw for b in busy} == {1 - aw0}
    te.recover_aw_requests()
    te.step()
    te.provision_aw(aw0)
    te.release_request("done0")
    free = list(te.aws[aw0].slots._free)
    assert sorted(free) == sorted(set(free)) and len(free) == 2
    assert slot in free
    new = [te.client.submit(RequestSpec(rid=f"new{i}", prompt=prompt,
                                         max_new=2)) for i in range(2)]
    placed = [(te.requests[n.rid]._aw, te.requests[n.rid].slot)
              for n in new]
    assert [a for a, _ in placed] == [aw0, aw0]
    assert placed[0][1] != placed[1][1]
