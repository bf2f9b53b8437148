"""The port's Whisper encoder-decoder against the JAX package on the CPU,
float32, fed the reference's params through ``repro_torch.convert`` and
seeded frames:

  * configs equal field for field, full and reduced, ``param_count``
    included; the port's own init draws the reference's leaves;
  * the encoder, ``cross_kv_init``, ``attn_cross``, and the model's
    prefill (cross K/V included) and decode logits, to 1e-4;
  * the engine's greedy streams equal the JAX engine's, with and without
    ``fail_aw(0)`` mid-decode, with the store's bytes_written equal (the
    cross K/V rides every token's segment, as in the reference);
  * a preempted request resumes from its log, as the reference's does:
    its cross K/V is restored, not recomputed from frames it no longer
    has (no second prefill), and its stream is unchanged;
  * a chunk budget keeps the whole-prompt path, as in the reference;
    paged KV, the prefix cache and decode segments are refused;
  * ``get_model`` dispatches every id of the reference's ``ARCH_IDS`` to
    the counterpart of the reference's builder.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import get_model as jget_model
from repro.models.layers import mlp as jmlp
from repro.models.layers import rmsnorm as jrmsnorm
from repro.serving.api import RequestSpec as JSpec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as tattn
from repro_torch.models import get_model as tget_model
from repro_torch.models import whisper as twhisper
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine

ARCH = "whisper_small"
TOL = dict(rtol=1e-4, atol=1e-4)
LENS = (12, 7, 9)
MAX_NEW = 8
FAIL_AT = 3
ECFG = dict(max_batch=4, max_seq=48, num_aw=2, num_ew=1)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def _frames(cfg, seed, b=None):
    shape = (cfg.encoder_seq, cfg.d_model) if b is None else \
        (b, cfg.encoder_seq, cfg.d_model)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match(reduced):
    j, t = jget_config(ARCH), tget_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count == j.param_count


def test_arch_ids_and_dispatch():
    """Every id of the reference's registry, full and reduced, builds the
    counterpart of the reference's builder."""
    assert sorted(ARCH_IDS) == sorted(J_ARCH_IDS)
    builders = {"build_encdec": "repro_torch.models.whisper",
                "build_xlstm": "repro_torch.models.xlstm_model",
                "build_hybrid": "repro_torch.models.hybrid",
                "build_decoder": "repro_torch.models.transformer"}
    for arch in J_ARCH_IDS:
        jcfg = jget_config(arch)
        jbuild = jget_model(jcfg.reduced()).init_params.__qualname__
        name = jbuild.split(".")[0]
        tapi = tget_model(tget_config(arch).reduced(), device="cpu")
        assert tapi.init_params.__qualname__.split(".")[0] == name, arch
        assert tapi.init_params.__module__ == builders[name], arch


def test_own_init_matches_reference_leaves():
    jp = jget_model(jget_config(ARCH).reduced()).init_params(
        jax.random.PRNGKey(0))
    tp = params_from_reference(jp, device="cpu")
    own = tget_model(tget_config(ARCH).reduced(), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert _shapes(own) == _shapes(tp)
    # the cross attention has no QKV bias, the self attention's leaves
    # are the decoder family's
    assert sorted(own["dec"][0]["cross_attn"]) == ["wk", "wo", "wq", "wv"]


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config(ARCH).reduced()
    tcfg = tget_config(ARCH).reduced()
    japi = jget_model(jcfg, num_aw=2, num_ew=1)
    tapi = tget_model(tcfg, num_aw=2, num_ew=1, device="cpu")
    jp = japi.init_params(jax.random.PRNGKey(0))
    return jcfg, tcfg, japi, tapi, jp, params_from_reference(jp,
                                                             device="cpu")


def _jencode(cfg, jp, frames):
    """The reference's encoder body, layer by layer."""
    b, t, _ = frames.shape
    positions = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (b, t))
    h = jnp.asarray(frames)
    for i in range(cfg.encoder_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], jp["enc"])
        a, _ = jattn.attn_full(cfg, lp["attn"],
                               jrmsnorm(lp["ln1"], h, cfg.norm_eps),
                               positions, causal=False)
        h = h + a
        h = h + jmlp(lp["mlp"], jrmsnorm(lp["ln2"], h, cfg.norm_eps),
                     cfg.act)
    return jrmsnorm(jp["enc_final_norm"], h, cfg.norm_eps)


def test_encoder_cross_kv_and_cross_attention(models):
    jcfg, tcfg, _, _, jp, tp = models
    fr = _frames(jcfg, 1, b=2)
    jenc = _jencode(jcfg, jp, fr)
    tenc = twhisper.encode(tcfg, tp, torch.from_numpy(fr))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **TOL)
    jlp = jax.tree_util.tree_map(lambda a: a[1], jp["dec"])["cross_attn"]
    tlp = tp["dec"][1]["cross_attn"]
    jkv = jattn.cross_kv_init(jcfg, jlp, jenc)
    tkv = tattn.cross_kv_init(tcfg, tlp, torch.from_numpy(
        np.array(jenc)))
    for k in ("k", "v"):
        np.testing.assert_allclose(tkv[k].numpy(), np.asarray(jkv[k]), **TOL)
    x = np.random.default_rng(2).normal(size=(2, 5, jcfg.d_model)).astype(
        np.float32)
    jout = jattn.attn_cross(jcfg, jlp, jnp.asarray(x), jkv)
    for blocked in (False, True):
        tout = tattn.attn_cross(tcfg, tlp, torch.from_numpy(x),
                                {k: torch.from_numpy(np.array(v))
                                 for k, v in jkv.items()}, blocked)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("s", [1, 13])
def test_prefill_and_decode_logits(models, s):
    jcfg, _, japi, tapi, jp, tp = models
    r = np.random.default_rng(s)
    toks = r.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)
    fr = _frames(jcfg, 10 + s, b=2)
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks),
                               "frames": jnp.asarray(fr)},
                          japi.init_route_state(), 32)
    tl, tc, _ = tapi.prefill(tp, torch.from_numpy(toks),
                             tapi.init_route_state(), 32,
                             frames=torch.from_numpy(fr))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["cross_" + k].transpose(0, 1).numpy(),
                                   np.asarray(jc["cross"][k]), **TOL)
    pos = np.full((2,), s, np.int32)
    for _ in range(3):
        nt = r.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
        jl, jc = japi.decode(jp, jnp.asarray(nt), jnp.asarray(pos), jc,
                             japi.init_route_state())
        tl, tc, _ = tapi.decode(tp, torch.from_numpy(nt),
                                torch.from_numpy(pos), tc,
                                tapi.init_route_state())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1


def test_prefill_needs_frames(models):
    _, _, _, tapi, _, tp = models
    with pytest.raises(ValueError, match="frames"):
        tapi.prefill(tp, torch.zeros((1, 4), dtype=torch.int32),
                     tapi.init_route_state(), 16)


def _serve(engine, spec_cls, prompts, frames, tag, fail_at=None,
           preempt_at=None):
    handles = [engine.client.submit(spec_cls(rid=f"{tag}{i}", prompt=p,
                                             max_new=MAX_NEW, frames=f))
               for i, (p, f) in enumerate(zip(prompts, frames))]
    steps, restored = 0, None
    while not all(h.done() for h in handles):
        if fail_at is not None and steps == fail_at:
            engine.fail_aw(0)
            restored = engine.recover_aw_requests(now=float(engine.steps))
            engine.step()
            engine.provision_aw(0)
        if preempt_at is not None and steps == preempt_at:
            assert engine.preempt_request(f"{tag}1", now=float(steps))
        engine.step()
        steps += 1
    out = [h.tokens() for h in handles]
    for h in reversed(handles):        # restore the slot free lists
        engine.release_request(h.rid)
    return out, restored


@pytest.fixture(scope="module")
def runs():
    jcfg = jget_config(ARCH).reduced()
    tcfg = tget_config(ARCH).reduced()
    je = JEngine(jcfg, JEngineConfig(**ECFG, telemetry=False,
                                     flight_recorder=False),
                 jax.random.PRNGKey(0))
    params = params_from_reference(je.params, device="cpu")
    te = InferenceEngine(tcfg, EngineConfig(**ECFG), params=params,
                         device="cpu")
    chunked = InferenceEngine(tcfg, EngineConfig(**ECFG,
                                                 chunk_token_budget=8),
                              params=params, device="cpu")
    r = np.random.default_rng(3)
    prompts = [r.integers(1, jcfg.vocab_size, size=(n,)).astype(np.int32)
               for n in LENS]
    frames = [_frames(jcfg, 20 + i) for i in range(len(LENS))]
    out = {"jax": _serve(je, JSpec, prompts, frames, "a")[0],
           "jax_bytes": je.store.stats.bytes_written,
           "port": _serve(te, RequestSpec, prompts, frames, "a")[0],
           "port_bytes": te.store.stats.bytes_written,
           "chunked": _serve(chunked, RequestSpec, prompts, frames, "a")[0],
           "jax_fail": _serve(je, JSpec, prompts, frames, "f", FAIL_AT)[0]}
    out["port_fail"], out["restored"] = _serve(te, RequestSpec, prompts,
                                               frames, "f", FAIL_AT)
    for name, eng, spec in (("jax", je, JSpec), ("port", te, RequestSpec)):
        calls, restores = eng.scheduler.stats.calls, \
            eng.store.stats.restores
        out[name + "_preempt"] = _serve(eng, spec, prompts, frames, "p",
                                        preempt_at=2)[0]
        out[name + "_preempt_calls"] = eng.scheduler.stats.calls - calls
        out[name + "_preempt_restores"] = eng.store.stats.restores - \
            restores
    fwd = jax.jit(je.api.forward_train)
    gaps = []
    for p, f, toks in zip(prompts, frames, out["jax"]):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])[None]
        lg = np.asarray(fwd(je.params, {"tokens": jnp.asarray(seq),
                                        "frames": jnp.asarray(f[None])},
                            je.api.init_route_state())[0])[0]
        top2 = np.sort(lg[len(p) - 1:], axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
    out["min_gap"] = min(gaps)
    return out, te, chunked


def test_greedy_streams_equal_reference(runs):
    out, _, _ = runs
    assert all(len(s) == MAX_NEW for s in out["jax"])
    assert out["min_gap"] > 1e-3      # a mismatch is a fault, not a tie
    assert out["port"] == out["jax"]


def test_streams_equal_reference_under_aw_failure(runs):
    out, te, _ = runs
    assert out["jax_fail"] == out["jax"]
    assert out["port_fail"] == out["port"]
    assert len(out["restored"]) == 1
    assert te.failed_aws == set() and te.gateway.depth() == 0


def test_store_bytes_equal_reference(runs):
    out, _, _ = runs
    assert out["port_bytes"] == out["jax_bytes"] > 0


def test_preempted_request_resumes_from_its_log(runs):
    """The reference requeues a victim with ``frames=None`` and restores
    its cross K/V from the store: one prefill per request, one restore,
    the stream unchanged. The port does the same."""
    out, _, _ = runs
    assert out["jax_preempt"] == out["jax"]
    assert out["port_preempt"] == out["port"]
    assert out["port_preempt_calls"] == out["jax_preempt_calls"] == \
        len(LENS)
    assert out["port_preempt_restores"] == out["jax_preempt_restores"] == 1


def test_chunk_budget_serves_whole_prompts(runs):
    out, _, chunked = runs
    assert chunked.chunked is None and not chunked.prefill_paddable
    assert out["chunked"] == out["port"]
    assert chunked.scheduler.stats.calls == len(LENS)


def test_segment_holds_the_cross_kv(runs):
    """Every token's segment carries the slot's cross K/V (the reference's
    state-leaf segment); a prompt's tokens share one host copy."""
    _, te, _ = runs
    f = _frames(te.cfg, 99)
    te.client.submit(RequestSpec(rid="seg", prompt=np.arange(1, 6),
                                 max_new=2, frames=f))
    r = te.requests["seg"]
    segs = te.store._logs["seg"].segments
    assert len(segs) == 5
    assert all(torch.equal(segs[t][2], te.cache["cross_k"][r.slot])
               for t in range(5))
    assert len({segs[t][2].untyped_storage().data_ptr()
                for t in range(5)}) == 1
    te.release_request("seg")


@pytest.mark.parametrize("kw,match", [
    (dict(chunk_token_budget=8, kv_page_tokens=16), "attention-only"),
    (dict(chunk_token_budget=8, prefix_cache_slots=2), "chunked-prefill"),
    (dict(decode_segment_len=4), "decode_segment_len")])
def test_refused(kw, match):
    with pytest.raises(ValueError, match=match):
        InferenceEngine(tget_config(ARCH).reduced(), EngineConfig(**ECFG,
                                                                  **kw),
                        device="cpu")
