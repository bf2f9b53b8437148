"""The port's SSD scan and Mamba2 block against the JAX package, on the
CPU: the plain chunked and sequential scans against ``repro.kernels.ref``
and against the Pallas kernel in interpret mode (2e-4, the bar
``tests/test_kernels.py`` holds the Pallas kernel to), at the reference's
test shapes, one step, odd lengths and across chunk sizes; ``ops.ssm_scan``
dispatch on the CPU; ``mamba_forward`` / ``mamba_decode_step`` against the
JAX block in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.ssm_scan import ssm_scan as pallas_scan
from repro.models import mamba2 as jmamba
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import mamba2 as tmamba

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(bs, s, h, p, n, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(bs, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(bs, s, h)))).astype(np.float32)
    a = -np.exp(r.normal(size=(h,)) * 0.5).astype(np.float32)
    b = (r.normal(size=(bs, s, n)) * 0.3).astype(np.float32)
    c = (r.normal(size=(bs, s, n)) * 0.3).astype(np.float32)
    return x, dt, a, b, c


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("bs,s,h,p,n,chunk", [
    (2, 128, 3, 16, 32, 32),
    (1, 64, 2, 8, 16, 64),    # single chunk
    (2, 96, 1, 4, 8, 16),     # non-pow2 length
    (1, 1, 2, 8, 16, 64),     # one step
    (2, 21, 2, 8, 16, 64),    # odd length: one chunk of 21
    (2, 192, 2, 8, 16, 64),   # three chunks
])
def test_plain_scans_match_reference_and_pallas(bs, s, h, p, n, chunk):
    arrs = _inputs(bs, s, h, p, n, seed=s + h)
    want_y, want_h = jref.ssm_scan_ref(*_j(arrs))
    kern_y, kern_h = pallas_scan(*_j(arrs), chunk=chunk, interpret=True)
    chk_y, chk_h = jref.ssm_scan_chunked_ref(*_j(arrs), chunk=chunk)
    for got_y, got_h in (tref.ssm_scan_ref(*_t(arrs)),
                         tref.ssm_scan_chunked_ref(*_t(arrs), chunk=chunk),
                         tops.ssm_scan(*_t(arrs), chunk=chunk)):
        for want, kern, chk, got in ((want_y, kern_y, chk_y, got_y),
                                     (want_h, kern_h, chk_h, got_h)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
            np.testing.assert_allclose(got.numpy(), np.asarray(chk), **TOL)


def test_chunk_length_follows_the_reference_rule():
    assert [tref.scan_chunk(s, 64) for s in (1, 21, 64, 96, 127, 128)] == \
        [1, 21, 64, 32, 1, 64]
    assert tref.scan_chunk(96, 16) == 16


def test_127_steps_run_at_chunk_1():
    """A 127-token prompt halves the chunk down to 1: the chunked form is
    then the recurrence step by step, and agrees with it."""
    arrs = _inputs(1, 127, 2, 8, 16, seed=3)
    want = tref.ssm_scan_ref(*_t(arrs))
    got = tops.ssm_scan(*_t(arrs), chunk=64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    jy, jh = jref.ssm_scan_chunked_ref(*_j(arrs), chunk=64)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jh), **TOL)


def test_chunk_invariance():
    """The chunk length does not change the result (the chunked form is
    exact, not an approximation)."""
    arrs = _t(_inputs(2, 64, 3, 8, 16, seed=11))
    outs = [tref.ssm_scan_chunked_ref(*arrs, chunk=ch) for ch in
            (4, 8, 16, 32, 64)]
    for y, hf in outs[1:]:
        np.testing.assert_allclose(y.numpy(), outs[0][0].numpy(), **TOL)
        np.testing.assert_allclose(hf.numpy(), outs[0][1].numpy(), **TOL)


def test_one_step_takes_the_sequential_form(monkeypatch):
    calls = []
    monkeypatch.setattr(tops, "ssm_scan_ref",
                        lambda *a, **k: calls.append("seq") or
                        tref.ssm_scan_ref(*a, **k))
    monkeypatch.setattr(tops, "ssm_scan_chunked_ref",
                        lambda *a, **k: calls.append("chunked") or
                        tref.ssm_scan_chunked_ref(*a, **k))
    tops.ssm_scan(*_t(_inputs(1, 1, 2, 4, 8, seed=0)))
    tops.ssm_scan(*_t(_inputs(1, 8, 2, 4, 8, seed=0)))
    assert calls == ["seq", "chunked"]


@pytest.fixture(scope="module")
def block():
    jcfg = jget_config("zamba2_7b").reduced()
    tcfg = tget_config("zamba2_7b").reduced()
    jp = jmamba.mamba_init(jax.random.PRNGKey(4), jcfg)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


def test_mamba_forward_and_decode_step_match_reference(block):
    jcfg, tcfg, jp, tp = block
    r = np.random.default_rng(5)
    x = (r.normal(size=(2, 19, jcfg.d_model)) * 0.5).astype(np.float32)
    jst = jmamba.init_state(jcfg, 2)
    tst = tmamba.init_state(tcfg, 2, device="cpu")
    jy, jst = jmamba.mamba_forward(jcfg, jp, jnp.asarray(x), jst)
    ty, tst = tmamba.mamba_forward(tcfg, tp, torch.from_numpy(x), tst)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-4, atol=1e-4)
    for _ in range(3):
        x1 = (r.normal(size=(2, 1, jcfg.d_model)) * 0.5).astype(np.float32)
        jy, jst = jmamba.mamba_decode_step(jcfg, jp, jnp.asarray(x1), jst)
        ty, tst = tmamba.mamba_decode_step(tcfg, tp, torch.from_numpy(x1),
                                           tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-4)
        for k in ("h", "conv"):
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       rtol=1e-4, atol=1e-4)


def test_own_init_matches_reference_shapes(block):
    jcfg, tcfg, jp, tp = block
    own = tmamba.mamba_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert {k: tuple(v.shape) if torch.is_tensor(v) else
            {kk: tuple(vv.shape) for kk, vv in v.items()}
            for k, v in own.items()} == \
        {k: tuple(v.shape) if torch.is_tensor(v) else
         {kk: tuple(vv.shape) for kk, vv in v.items()}
         for k, v in tp.items()}
    np.testing.assert_allclose(own["a_log"].numpy(), tp["a_log"].numpy(),
                               rtol=1e-6)
    assert abs(own["in_proj"].std().item() / tp["in_proj"].std().item()
               - 1) < 0.1


def test_bf16_block_casts_every_float_leaf_as_the_reference():
    """``cast_tree`` casts every float leaf of the reference's params,
    ``a_log``, ``dt_bias``, ``d_skip`` and ``conv_w`` included; the port's
    hybrid init does the same."""
    from repro_torch.models import get_model
    cfg = dataclasses.replace(tget_config("zamba2_7b").reduced(),
                              dtype="bfloat16")
    params = get_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    for name, leaf in params["blocks"][0]["mamba"].items():
        leaves = leaf.values() if isinstance(leaf, dict) else [leaf]
        assert all(t.dtype == torch.bfloat16 for t in leaves), name
