"""The port's Zamba2 hybrid (Mamba2 blocks + one shared attention block)
against the JAX package on the CPU, float32, fed the reference's params
through ``repro_torch.convert``:

  * configs and parameter counts match; the port's own init draws the
    reference's shapes;
  * prefill and decode logits to 1e-4, with and without a trailing block
    (reduced 4 layers: two units of 2; 5 layers: plus one trailing block);
  * the engine's greedy streams equal the JAX engine's, with and without
    ``fail_aw(0)`` mid-decode (the twin of
    ``test_ssm_arch_aw_failover_exact``); the restored recurrent state is
    the last committed token's snapshot; the store's bytes_written equal
    the JAX store's; a prompt's checkpointed state is one host copy;
  * ``chunk_token_budget > 0`` serves whole prompts, as the reference does;
    a paged hybrid is refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
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
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine

TOL = dict(rtol=1e-4, atol=1e-4)
LENS = (12, 7, 9)
MAX_NEW = 8
FAIL_AT = 3
ECFG = dict(max_batch=4, max_seq=48, num_aw=2, num_ew=1)


def _cfgs(num_layers):
    return (dataclasses.replace(jget_config("zamba2_7b").reduced(),
                                num_layers=num_layers),
            dataclasses.replace(tget_config("zamba2_7b").reduced(),
                                num_layers=num_layers))


def test_configs_match():
    j, t = jget_config("zamba2_7b"), tget_config("zamba2_7b")
    for cj, ct in ((j, t), (j.reduced(), t.reduced())):
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim_", "d_ff", "vocab_size", "hybrid_attn_every",
                  "tie_embeddings", "norm_eps", "dtype", "param_count"):
            assert getattr(ct, f) == getattr(cj, f), f
        assert ct.ssm.__dict__ == cj.ssm.__dict__
    assert t.head_dim_ == 112


@pytest.mark.parametrize("num_layers", [4, 5])
def test_prefill_and_decode_logits(num_layers):
    jcfg, tcfg = _cfgs(num_layers)
    japi = jget_model(jcfg, num_aw=2, num_ew=1)
    tapi = tget_model(tcfg, num_aw=2, num_ew=1, device="cpu")
    jp = japi.init_params(jax.random.PRNGKey(0))
    tp = params_from_reference(jp, device="cpu")
    assert len(tp["blocks"]) == num_layers
    r = np.random.default_rng(num_layers)
    toks = r.integers(0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks)},
                          japi.init_route_state(), 32)
    tl, tc, _ = tapi.prefill(tp, torch.from_numpy(toks),
                             tapi.init_route_state(), 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = np.array([13, 13], np.int32)
    for _ in range(3):
        nt = r.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
        jl, jc = japi.decode(jp, jnp.asarray(nt), jnp.asarray(pos), jc,
                             japi.init_route_state())
        tl, tc, _ = tapi.decode(tp, torch.from_numpy(nt),
                                torch.from_numpy(pos), tc,
                                tapi.init_route_state())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1
    # the state leaves, block by block in execution order
    jh = np.concatenate([np.asarray(jc["units"]["h"]).reshape(
        -1, *jc["units"]["h"].shape[2:])] + ([np.asarray(jc["trailing"][
            "h"])] if "trailing" in jc else []))
    np.testing.assert_allclose(tc["h"].transpose(0, 1).numpy(), jh, **TOL)


def test_own_init_matches_reference_shapes():
    jcfg, tcfg = _cfgs(5)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_reference(jp, device="cpu")
    own = tget_model(tcfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(own) == shapes(tp)


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


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = _cfgs(5)
    je = JEngine(jcfg, JEngineConfig(**ECFG, telemetry=False,
                                     flight_recorder=False),
                 jax.random.PRNGKey(0))
    params = params_from_reference(je.params, device="cpu")
    te = InferenceEngine(tcfg, EngineConfig(**ECFG), params=params,
                         device="cpu")
    chunked = InferenceEngine(tcfg, EngineConfig(**ECFG,
                                                 chunk_token_budget=8),
                              params=params, device="cpu")
    # seed 7: every greedy choice along these streams wins by >= 9e-3
    r = np.random.default_rng(7)
    prompts = [r.integers(1, jcfg.vocab_size, size=(n,)).astype(np.int32)
               for n in LENS]
    out = {"jax": _serve(je, JSpec, prompts, "a")[0],
           "jax_bytes": je.store.stats.bytes_written,
           "port": _serve(te, RequestSpec, prompts, "a")[0],
           "port_bytes": te.store.stats.bytes_written,
           "chunked": _serve(chunked, RequestSpec, prompts, "a")[0],
           "jax_fail": _serve(je, JSpec, prompts, "f", FAIL_AT)[0]}
    out["port_fail"], out["restored"] = _serve(te, RequestSpec, prompts,
                                               "f", FAIL_AT)
    fwd = jax.jit(je.api.forward_train)
    gaps = []
    for p, toks in zip(prompts, out["jax"]):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])[None]
        lg = np.asarray(fwd(je.params, {"tokens": jnp.asarray(seq)},
                            je.api.init_route_state())[0])[0]
        top2 = np.sort(lg[len(p) - 1:], axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
    out["min_gap"] = min(gaps)
    return out, te, chunked, prompts


def test_greedy_streams_equal_reference(runs):
    out, _, _, _ = runs
    assert all(len(s) == MAX_NEW for s in out["jax"])
    assert out["min_gap"] > 1e-3      # a mismatch is a fault, not a tie
    assert out["port"] == out["jax"]


def test_streams_equal_reference_under_aw_failure(runs):
    out, te, _, _ = runs
    assert out["jax_fail"] == out["jax"]
    assert out["port_fail"] == out["port"]
    # two requests on AW0, one free slot on AW1: one restored at once, the
    # other at the step after provision_aw(0)
    assert len(out["restored"]) == 1
    assert te.failed_aws == set() and te.gateway.depth() == 0
    assert te.store.stats.restores >= 2


def test_store_bytes_equal_reference(runs):
    out, _, _, _ = runs
    assert out["port_bytes"] == out["jax_bytes"] > 0


def test_chunk_budget_serves_whole_prompts(runs):
    out, _, chunked, _ = runs
    assert chunked.chunked is None and not chunked.prefill_paddable
    assert out["chunked"] == out["port"]
    assert chunked.scheduler.stats.calls == len(LENS)


def test_restore_writes_the_last_committed_snapshot(runs):
    _, te, _, prompts = runs
    h = te.client.submit(RequestSpec(rid="snap", prompt=prompts[0],
                                     max_new=MAX_NEW))
    for _ in range(3):
        te.step()
    r = te.requests["snap"]
    live = {k: te.cache[k][r.slot].clone() for k in ("h", "conv")}
    committed = te.store.committed_token("snap")
    assert committed == r.pos - 1
    seg = te.store._logs["snap"].segments[committed]
    # an earlier token's snapshot differs: restoring it would rewind
    older = te.store._logs["snap"].segments[committed - 1]
    assert not torch.equal(seg[2], older[2])
    aw = r.aw
    te.fail_aw(aw)
    assert te.recover_aw_requests() == ["snap"]
    r = te.requests["snap"]
    assert r.aw != aw
    for j, k in enumerate(("h", "conv")):
        assert torch.equal(te.cache[k][r.slot], seg[2 + j])
        assert torch.equal(te.cache[k][r.slot], live[k])
    te.provision_aw(aw)
    while not h.done():
        te.step()
    te.release_request("snap")
    # a released slot's state is zeroed
    assert not te.cache["h"][r.slot].any()


def test_prompt_checkpoint_holds_one_state_copy(runs):
    """Every prompt token's segment carries the same state snapshot; the
    host keeps one copy of it, not one per token."""
    _, te, _, prompts = runs
    te.client.submit(RequestSpec(rid="host", prompt=prompts[0], max_new=2))
    segs = te.store._logs["host"].segments
    n = len(prompts[0])
    ptrs = {segs[t][2].untyped_storage().data_ptr() for t in range(n)}
    assert len(ptrs) == 1
    assert all(torch.equal(segs[t][2], segs[0][2]) for t in range(n))
    te.release_request("host")


def test_mixed_slot_segments_share_one_state_copy_per_slot():
    """A gather over pairs from several slots (a decode step's, or any
    mix) gives each pair its own slot's whole state, from one host copy
    per distinct slot."""
    from repro_torch.serving.kvcache import CacheLayout
    _, tcfg = _cfgs(5)
    tapi = tget_model(tcfg, num_aw=2, num_ew=1, device="cpu")
    cache = tapi.init_cache(4, 16)
    g = torch.Generator().manual_seed(0)
    for name in ("h", "conv"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=g))
    slots, tokens = [2, 0, 2, 3, 0, 2], [5, 1, 6, 0, 2, 7]
    segs = CacheLayout().extract_tokens(cache, slots, tokens)
    for j, name in enumerate(("h", "conv")):
        leaf = segs[2 + j]
        assert len(leaf) == len(slots)
        for i, s in enumerate(slots):
            assert torch.equal(leaf[i], cache[name][s])
        ptrs = {leaf[i].data_ptr() for i in range(len(slots))}
        assert len(ptrs) == len(set(slots))
    assert torch.equal(segs[1][:, 0],
                       cache["layers"][0]["pos"][slots, tokens])


def test_paged_hybrid_is_refused():
    _, tcfg = _cfgs(4)
    with pytest.raises(ValueError, match="attention-only"):
        InferenceEngine(tcfg, EngineConfig(**ECFG, chunk_token_budget=8,
                                           kv_page_tokens=16),
                        device="cpu")
