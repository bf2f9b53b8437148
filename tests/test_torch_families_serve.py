"""The engines of the rest of the transformer family in the port
(Qwen1.5-MoE-A2.7B, Kimi-K2, Chameleon-34B, Granite-34B) against the JAX
engine on the CPU, float32, reduced configs (capacity factor 4 for the MoE
pair), the port fed the reference engine's params through
``repro_torch.convert``:

  * the engine's greedy streams equal the JAX engine's, and under
    ``fail_aw(0)`` (and ``fail_ew(0)`` for the MoE pair) they equal both
    the failure-free streams and the JAX engine's under the same failure;
  * Qwen1.5-MoE: paged equals contiguous and chunked equals whole-prompt,
    bit for bit.

The configs, the init and the logits are in ``test_torch_families.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.serving.api import RequestSpec as JSpec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from test_torch_families import ARCHS
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine

LENS = (6, 12, 15, 9)           # one prefill bucket (16)
MAX_NEW = 10
FAIL_AT = 4
ECFG = dict(max_batch=4, max_seq=32, num_aw=2, num_ew=2)
# per model, a prompt seed whose greedy choices along the streams all win
# by >= 3e-3 (a mismatch is then a fault, not a near-tie)
PROMPT_SEED = {"qwen2_moe_a2_7b": 5, "kimi_k2_1t_a32b": 2,
               "chameleon_34b": 3, "granite_34b": 9}


def _moe_cf4(cfg):
    """Capacity factor 4: no token is dropped, so neither a slot, a
    chunking nor a failover can change a stream (as the reference's
    quickstart serves its MoE)."""
    if not cfg.moe.enabled:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))


def _serve(engine, spec_cls, prompts, tag, fail_aw_at=None,
           fail_ew_at=None):
    """Every prompt to the end; with ``fail_aw_at``, ``fail_aw(0)`` before
    that step, recover, one step, provision; with ``fail_ew_at``,
    ``fail_ew(0)`` before that step (provisioned after the run)."""
    handles = [engine.client.submit(spec_cls(rid=f"{tag}{i}", prompt=p,
                                             max_new=MAX_NEW))
               for i, p in enumerate(prompts)]
    steps = 0
    while not all(h.done() for h in handles):
        if steps == fail_aw_at:
            engine.fail_aw(0)
            engine.recover_aw_requests(now=float(engine.steps))
            engine.step()
            engine.provision_aw(0)
        if steps == fail_ew_at:
            engine.fail_ew(0)
        engine.step()
        steps += 1
    out = [h.tokens() for h in handles]
    for h in reversed(handles):        # restore the slot free lists
        engine.release_request(h.rid)
    if fail_ew_at is not None:
        engine.provision_ew(0)
    return out


@functools.lru_cache(maxsize=len(ARCHS))
def _runs(arch):
    """The JAX and the port engine on one reduced model (capacity factor
    4 for the MoE pair): streams with and without the failures, and the
    smallest greedy gap along them."""
    jcfg = _moe_cf4(jget_config(arch).reduced())
    tcfg = _moe_cf4(tget_config(arch).reduced())
    je = JEngine(jcfg, JEngineConfig(**ECFG, telemetry=False,
                                     flight_recorder=False),
                 jax.random.PRNGKey(0))
    params = params_from_reference(je.params, device="cpu")
    te = InferenceEngine(tcfg, EngineConfig(**ECFG), params=params,
                         device="cpu")
    r = np.random.default_rng(PROMPT_SEED[arch])
    prompts = [r.integers(1, jcfg.vocab_size, size=(n,)).astype(np.int32)
               for n in LENS]
    out = {"jax": _serve(je, JSpec, prompts, "a"),
           "port": _serve(te, RequestSpec, prompts, "a"),
           "jax_aw": _serve(je, JSpec, prompts, "f", fail_aw_at=FAIL_AT),
           "port_aw": _serve(te, RequestSpec, prompts, "f",
                             fail_aw_at=FAIL_AT)}
    if tcfg.moe.enabled:
        out["jax_ew"] = _serve(je, JSpec, prompts, "e", fail_ew_at=FAIL_AT)
        out["port_ew"] = _serve(te, RequestSpec, prompts, "e",
                                fail_ew_at=FAIL_AT)
    # the reference's logits along its own streams (one causal forward of
    # the right-padded sequences), for the tie check
    seqs = [np.concatenate([p, np.asarray(t[:-1], np.int32)])
            for p, t in zip(prompts, out["jax"])]
    batch = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, q in enumerate(seqs):
        batch[i, :len(q)] = q
    lg = np.asarray(jax.jit(je.api.forward_train)(
        je.params, {"tokens": jnp.asarray(batch)},
        je.api.init_route_state())[0])
    gaps = []
    for i, (p, q) in enumerate(zip(prompts, seqs)):
        top2 = np.sort(lg[i, len(p) - 1:len(q)], axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
    out["min_gap"] = min(gaps)
    return tcfg, params, prompts, out, te


@pytest.fixture(params=ARCHS)
def runs(request):
    return _runs(request.param)


def test_greedy_streams_equal_reference(runs):
    _, _, _, out, _ = runs
    assert all(len(s) == MAX_NEW for s in out["jax"])
    assert out["min_gap"] > 1e-3      # a mismatch is a fault, not a tie
    assert out["port"] == out["jax"]


def test_streams_equal_reference_under_failures(runs):
    tcfg, _, _, out, te = runs
    assert out["jax_aw"] == out["jax"]
    assert out["port_aw"] == out["port"] == out["jax"]
    assert te.failed_aws == set() and te.store.stats.restores >= 1
    if tcfg.moe.enabled:
        assert out["jax_ew"] == out["jax"]
        assert out["port_ew"] == out["port"]
        assert te.failed_ews == set()


def test_qwen_moe_paged_and_chunked_streams_are_bitwise():
    tcfg, params, prompts, out, _ = _runs("qwen2_moe_a2_7b")
    chunked = InferenceEngine(tcfg, EngineConfig(**ECFG,
                                                 chunk_token_budget=8),
                              params=params, device="cpu")
    paged = InferenceEngine(tcfg, EngineConfig(**ECFG, chunk_token_budget=8,
                                               kv_page_tokens=16),
                            params=params, device="cpu")
    assert chunked.chunked is not None and paged.pages is not None
    got_chunked = _serve(chunked, RequestSpec, prompts, "c")
    got_paged = _serve(paged, RequestSpec, prompts, "p")
    assert got_paged == got_chunked
    assert got_chunked == out["port"]
    paged.pages.check()
