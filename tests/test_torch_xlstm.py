"""The port's xLSTM (mLSTM/sLSTM blocks, recurrent state only) against the
JAX package on the CPU, float32, fed the reference's params through
``repro_torch.convert``:

  * configs equal field for field, full and reduced, ``param_count``
    included; the port's own init draws the reference's leaves;
  * the mLSTM's chunkwise and recurrent forms, ``mlstm_forward`` and
    ``slstm_forward`` from a non-zero state, and the model's prefill and
    decode steps at S 1, 7, 64 and 128, states included, to 1e-4;
  * the engine's greedy streams equal the JAX engine's, with and without
    ``fail_aw(0)`` mid-decode (the twin of
    ``test_ssm_arch_aw_failover_exact``), with the store's bytes_written
    equal; the restored state is the last committed snapshot;
  * a chunk budget keeps the whole-prompt path, as in the reference;
    paged KV, the prefix cache and decode segments are refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.models import xlstm as jxl
from repro.serving.api import RequestSpec as JSpec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.models import get_model as tget_model
from repro_torch.models import xlstm as txl
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine

ARCH = "xlstm_350m"
TOL = dict(rtol=1e-4, atol=1e-4)
LENS = (12, 7, 9)
MAX_NEW = 8
FAIL_AT = 3
ECFG = dict(max_batch=4, max_seq=48, num_aw=2, num_ew=1)
STATE = ("mlstm_c", "mlstm_n", "mlstm_m", "slstm_c", "slstm_n", "slstm_m",
         "slstm_h")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match(reduced):
    j, t = jget_config(ARCH), tget_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count == j.param_count


def test_own_init_matches_reference_leaves():
    cfg = tget_config(ARCH).reduced()
    jp = jget_model(jget_config(ARCH).reduced()).init_params(
        jax.random.PRNGKey(0))
    tp = params_from_reference(jp, device="cpu")
    own = tget_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert _shapes(own) == _shapes(tp)
    assert [sorted(b["cell"]) for b in own["blocks"]] == [
        sorted(jp["blocks"][i]["cell"]) for i in range(2)]


@pytest.fixture(scope="module")
def cell_params():
    cfg = jget_config(ARCH).reduced()
    jp = jget_model(cfg).init_params(jax.random.PRNGKey(1))
    tp = params_from_reference(jp, device="cpu")
    mj = {k: v[0] for k, v in jp["blocks"][0]["cell"].items()
          if k != "norm"}
    mj["norm"] = {"scale": jp["blocks"][0]["cell"]["norm"]["scale"][0]}
    sj = {k: v[0] for k, v in jp["blocks"][1]["cell"].items()
          if k != "norm"}
    sj["norm"] = {"scale": jp["blocks"][1]["cell"]["norm"]["scale"][0]}
    return cfg, mj, sj, tp["blocks"][0]["cell"], tp["blocks"][1]["cell"]


def _state(r, shapes):
    """A non-zero state: c, n, h drawn, m below the gates' range."""
    return {k: (r.normal(size=s) * (0.1 if k != "m" else 1.0)
                ).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("s", [1, 7, 64, 128])
def test_mlstm_forms_and_forward(cell_params, s):
    cfg, mj, _, mt, _ = cell_params
    r = np.random.default_rng(s)
    b, h, dh = 2, cfg.num_heads, cfg.d_model // cfg.num_heads
    x = r.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    st = _state(r, {"c": (b, h, dh, dh), "n": (b, h, dh), "m": (b, h)})
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    qkvif_j = jxl._mlstm_projections(cfg, mj, jnp.asarray(x))
    qkvif_t = txl._mlstm_projections(cfg, mt, torch.from_numpy(x))
    for a, e in zip(qkvif_t, qkvif_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **TOL)
    forms = [(txl._mlstm_recurrent, jxl._mlstm_recurrent)]
    if s > 1:
        forms.append((txl._mlstm_chunked, jxl._mlstm_chunked))
    for tf, jf in forms:
        th, tsf = tf(*qkvif_t, tst)
        jh, jsf = jf(*qkvif_j, jst)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        for k in ("c", "n", "m"):
            np.testing.assert_allclose(tsf[k].numpy(), np.asarray(jsf[k]),
                                       **TOL)
    ty, tsf = txl.mlstm_forward(cfg, mt, torch.from_numpy(x), tst)
    jy, jsf = jxl.mlstm_forward(cfg, mj, jnp.asarray(x), jst)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in ("c", "n", "m"):
        np.testing.assert_allclose(tsf[k].numpy(), np.asarray(jsf[k]), **TOL)


@pytest.mark.parametrize("s", [1, 7, 64, 128])
def test_slstm_forward(cell_params, s):
    cfg, _, sj, _, stp = cell_params
    r = np.random.default_rng(100 + s)
    d = cfg.d_model
    x = r.normal(size=(2, s, d)).astype(np.float32)
    st = _state(r, {k: (2, d) for k in ("c", "n", "m", "h")})
    ty, tsf = txl.slstm_forward(cfg, stp, torch.from_numpy(x),
                                {k: torch.from_numpy(v)
                                 for k, v in st.items()})
    jy, jsf = jxl.slstm_forward(cfg, sj, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in st.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in ("c", "n", "m", "h"):
        np.testing.assert_allclose(tsf[k].numpy(), np.asarray(jsf[k]), **TOL)


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config(ARCH).reduced()
    japi = jget_model(jcfg, num_aw=2, num_ew=1)
    tapi = tget_model(tget_config(ARCH).reduced(), num_aw=2, num_ew=1,
                      device="cpu")
    jp = japi.init_params(jax.random.PRNGKey(0))
    return jcfg, japi, tapi, jp, params_from_reference(jp, device="cpu")


def _check_states(tc, jc):
    """The port's [B, L, ...] state leaves against the reference's
    (mLSTM, sLSTM) dicts of [r, B, ...]."""
    for name in STATE:
        kind, leaf = name.split("_")
        want = np.asarray(jc[0 if kind == "mlstm" else 1][leaf])
        np.testing.assert_allclose(tc[name].transpose(0, 1).numpy(), want,
                                   **TOL)


@pytest.mark.parametrize("s", [1, 7, 64, 128])
def test_prefill_and_decode_steps(models, s):
    jcfg, japi, tapi, jp, tp = models
    r = np.random.default_rng(s)
    toks = r.integers(0, jcfg.vocab_size, (2, s)).astype(np.int32)
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks)},
                          japi.init_route_state())
    tl, tc, _ = tapi.prefill(tp, torch.from_numpy(toks),
                             tapi.init_route_state(), s + 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_states(tc, jc)
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
    _check_states(tc, jc)


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
    live = {k: te.cache[k][r.slot].clone() for k in STATE}
    committed = te.store.committed_token("snap")
    assert committed == r.pos - 1
    seg = te.store._logs["snap"].segments[committed]
    # no attention layer: the segment's KV and positions are empty
    assert seg[0].numel() == 0 and seg[1].numel() == 0
    aw = r.aw
    te.fail_aw(aw)
    assert te.recover_aw_requests() == ["snap"]
    r = te.requests["snap"]
    assert r.aw != aw
    for j, k in enumerate(STATE):
        assert torch.equal(te.cache[k][r.slot], seg[2 + j])
        assert torch.equal(te.cache[k][r.slot], live[k])
    te.provision_aw(aw)
    while not h.done():
        te.step()
    te.release_request("snap")
    assert not te.cache["mlstm_c"][r.slot].any()


@pytest.mark.parametrize("kw,match", [
    (dict(chunk_token_budget=8, kv_page_tokens=16), "attention-only"),
    (dict(chunk_token_budget=8, prefix_cache_slots=2), "chunked-prefill"),
    (dict(decode_segment_len=4), "decode_segment_len")])
def test_refused(kw, match):
    with pytest.raises(ValueError, match=match):
        InferenceEngine(tget_config(ARCH).reduced(), EngineConfig(**ECFG,
                                                                  **kw),
                        device="cpu")
