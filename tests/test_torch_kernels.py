"""The port's plain kernel versions against the JAX package's kernels, as
the JAX tests run them on the CPU: ``repro.kernels.ref`` oracles and the
Pallas kernels in interpret mode. Inputs are drawn with numpy from a seed
and handed to both. float32 throughout, at the bar of
tests/test_kernels.py (2e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_fused
from repro.kernels.flash_attention import flash_attention
from repro.kernels.moe_gemm import moe_gemm
from repro.models.attention import blockwise_attention as jblockwise
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.moe_gemm import expert_ffn_plain
from repro_torch.models.attention import blockwise_attention

TOL = dict(rtol=2e-5, atol=2e-5)


def _decode_inputs(seed, b, h, hkv, dh, sc):
    r = np.random.default_rng(seed)
    f = np.float32
    q = r.normal(size=(b, h, dh)).astype(f)
    ck = r.normal(size=(b, sc, hkv, dh)).astype(f)
    cv = r.normal(size=(b, sc, hkv, dh)).astype(f)
    k1 = r.normal(size=(b, hkv, dh)).astype(f)
    v1 = r.normal(size=(b, hkv, dh)).astype(f)
    pos = (np.arange(b) * 7 + sc // 2).astype(np.int32)
    ar = np.arange(sc)[None]
    cpos = np.where(ar <= pos[:, None], ar, -1).astype(np.int32)
    cpos[0, 3:9] = -1                    # holes in the cache (scrubbed pads)
    return q, ck, cv, cpos, k1, v1, pos


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


@pytest.mark.parametrize("b,h,hkv,dh,sc", [
    (1, 4, 1, 64, 128),
    (2, 8, 2, 32, 96),     # GQA
    (3, 6, 6, 32, 40),     # MHA
])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 30.0)])
def test_decode_partial_and_full_ref(b, h, hkv, dh, sc, window, softcap):
    args = _decode_inputs(b * 100 + h, b, h, hkv, dh, sc)
    q, ck, cv, cpos, k1, v1, pos = args
    want = jref.decode_attention_partial_ref(
        *_j(q, ck, cv, cpos, pos), window=window, softcap=softcap)
    got = tref.decode_attention_partial_ref(
        *_t(q, ck, cv, cpos, pos), window=window, softcap=softcap)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    want = jref.decode_attention_ref(*_j(*args), window=window,
                                     softcap=softcap)
    got = tref.decode_attention_ref(*_t(*args), window=window,
                                    softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the plain version of the CUDA kernel, against the reference's CPU
    # path (partials + combine) -- bitwise-close, same algorithm
    want = jops.decode_attention(*_j(*args), window=window, softcap=softcap)
    got = tops.decode_attention(*_t(*args), window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 0.0), (0, 30.0)])
def test_decode_plain_vs_pallas_fused(window, softcap):
    """The plain version against the TPU kernel itself (interpret mode)."""
    args = _decode_inputs(7, 2, 8, 2, 32, 64)
    want = decode_attention_fused(*_j(*args), window=window, softcap=softcap,
                                  block_k=16, interpret=True)
    got = decode_attention_plain(*_t(*args), window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _prefill_inputs(seed, b, s, h, hkv, dh):
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, s, h, dh)).astype(np.float32)
    k = r.normal(size=(b, s, hkv, dh)).astype(np.float32)
    v = r.normal(size=(b, s, hkv, dh)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    return q, k, v, pos


@pytest.mark.parametrize("b,s,h,hkv,dh", [(2, 64, 4, 2, 32),
                                          (1, 48, 6, 6, 32)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 0.0), (0, 30.0)])
def test_blockwise_vs_reference_blockwise(b, s, h, hkv, dh, window,
                                          softcap):
    """Prefill plain version at the pinned KV block (PREFILL_BLOCK_K) vs
    the reference's blockwise attention, with padded (-1) keys."""
    q, k, v, pos = _prefill_inputs(b + s, b, s, h, hkv, dh)
    kpos = pos.copy()
    kpos[0, s - 5:] = -1                 # padded tail of row 0
    kw = dict(window=window, softcap=softcap, block_k=16)
    want = jblockwise(*_j(q, k, v, pos, kpos), **kw)
    got = blockwise_attention(*_t(q, k, v, pos, kpos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,softcap,causal", [(0, 0.0, True),
                                                   (8, 0.0, True),
                                                   (0, 30.0, True),
                                                   (0, 0.0, False)])
def test_blockwise_vs_pallas_flash(window, softcap, causal):
    """Against the TPU flash kernel (interpret mode), including query rows
    with position -1 (no valid key: both give 0)."""
    q, k, v, pos = _prefill_inputs(3, 2, 32, 4, 2, 32)
    qpos = pos.copy()
    qpos[1, 24:] = -1
    kpos = pos.copy()
    kpos[1, 24:] = -1
    kw = dict(window=window, softcap=softcap, causal=causal)
    want = flash_attention(*_j(q, k, v, qpos, kpos), block_q=16,
                           block_k=16, interpret=True, **kw)
    got = tops.full_attention(*_t(q, k, v, qpos, kpos), block_k=16, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if causal:
        assert float(got[1, 24:].abs().max()) == 0.0


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
def test_moe_gemm_ref(gated, act):
    r = np.random.default_rng(11)
    x = r.normal(size=(4, 2, 8, 48)).astype(np.float32)   # [P, G, C, D]
    wg = (r.normal(size=(4, 48, 80)) * 0.1).astype(np.float32)
    wu = (r.normal(size=(4, 48, 80)) * 0.1).astype(np.float32)
    wd = (r.normal(size=(4, 80, 48)) * 0.1).astype(np.float32)
    want = jref.moe_gemm_ref(*_j(x), jnp.asarray(wg) if gated else None,
                             *_j(wu, wd), act=act)
    got = tref.moe_gemm_ref(*_t(x), torch.from_numpy(wg) if gated else None,
                            *_t(wu, wd), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
def test_expert_ffn_plain_vs_pallas(gated, act):
    """The port's expert FFN takes the stored bank plus slot_expert; the
    reference's model path gathers the slot bank first and then runs the
    TPU kernel. Slots with count 0 are 0 in both, and a -1 slot reads
    expert 0 as the reference's gather does."""
    r = np.random.default_rng(5)
    p, c, d, f, e = 6, 16, 32, 64, 4
    x = r.normal(size=(p, c, d)).astype(np.float32)
    bank = {k: (r.normal(size=shape) * 0.1).astype(np.float32)
            for k, shape in (("wg", (e, d, f)), ("wu", (e, d, f)),
                             ("wd", (e, f, d)))}
    slot_expert = np.array([0, 1, 2, 3, 1, -1], np.int32)
    counts = np.array([3, 0, 16, 1, 2, 5], np.int32)
    idx = np.maximum(slot_expert, 0)
    want = moe_gemm(jnp.asarray(x),
                    jnp.asarray(bank["wg"][idx]) if gated else None,
                    jnp.asarray(bank["wu"][idx]), jnp.asarray(bank["wd"][idx]),
                    counts=jnp.asarray(counts), act=act, block_c=16,
                    block_f=32, interpret=True)
    got = expert_ffn_plain(
        torch.from_numpy(x), torch.from_numpy(bank["wg"]) if gated else None,
        torch.from_numpy(bank["wu"]), torch.from_numpy(bank["wd"]),
        torch.from_numpy(slot_expert), torch.from_numpy(counts), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[1].abs().max()) == 0.0
    # ops dispatch: a [P, G, C, D] batch flattens and comes back
    got4 = tops.expert_ffn(torch.from_numpy(x).reshape(p, 2, c // 2, d),
                           torch.from_numpy(bank["wg"]) if gated else None,
                           torch.from_numpy(bank["wu"]),
                           torch.from_numpy(bank["wd"]),
                           torch.from_numpy(slot_expert),
                           torch.from_numpy(counts), act=act)
    np.testing.assert_allclose(got4.reshape(p, c, d).numpy(), got.numpy(),
                               rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_path_without_building():
    """Dispatch by device: CPU tensors never touch nvcc or ctypes."""
    from repro_torch.kernels import build
    args = _t(*_decode_inputs(1, 1, 4, 2, 32, 16))
    tops.decode_attention(*args)
    assert build._libs == {}
