"""The port's CUDA kernels against their plain PyTorch versions, on the
card. CUDA kernels have no CPU mode, so every test here needs an NVIDIA
GPU and nvcc, and skips elsewhere. On a GPU machine (which need not have
JAX, so conftest.py is left out):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ops
from repro_torch.models.attention import blockwise_attention

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _randn(r, shape, dtype, dev, scale=1.0):
    return torch.from_numpy((r.normal(size=shape) * scale).astype(
        np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,dh,sc", [(2, 8, 2, 64, 96),
                                          (3, 32, 8, 128, 200),
                                          (1, 4, 4, 32, 17),
                                          (2, 16, 2, 32, 40),
                                          (1, 4, 2, 128, 33)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 30.0)])
def test_decode_attention_kernel(dev, dtype, b, h, hkv, dh, sc, window,
                                 softcap):
    r = np.random.default_rng(b * 10 + h)
    q = _randn(r, (b, h, dh), dtype, dev)
    ck, cv = (_randn(r, (b, sc, hkv, dh), dtype, dev) for _ in range(2))
    k1, v1 = (_randn(r, (b, hkv, dh), dtype, dev) for _ in range(2))
    pos = torch.tensor(r.integers(1, sc, size=(b,)), dtype=torch.int32,
                       device=dev)
    ar = torch.arange(sc, device=dev, dtype=torch.int32)[None]
    cpos = torch.where(ar < pos[:, None], ar, torch.full_like(ar, -1))
    args = (q, ck, cv, cpos, k1, v1, pos)
    kw = dict(window=window, softcap=softcap)
    n = da.KERNEL.launches
    _close(ops.decode_attention(*args, **kw),
           da.decode_attention_plain(*args, **kw), dtype)
    assert da.KERNEL.launches == n + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,dh", [(2, 40, 6, 2, 32),
                                          (1, 128, 32, 8, 128)])
@pytest.mark.parametrize("window,softcap,causal", [(0, 0.0, True),
                                                   (8, 0.0, True),
                                                   (0, 30.0, True),
                                                   (0, 0.0, False)])
def test_flash_attention_kernel(dev, dtype, b, s, h, hkv, dh, window,
                                softcap, causal):
    r = np.random.default_rng(s)
    q = _randn(r, (b, s, h, dh), dtype, dev)
    k, v = (_randn(r, (b, s, hkv, dh), dtype, dev) for _ in range(2))
    p = torch.arange(s, device=dev, dtype=torch.int32).repeat(b, 1)
    p[-1, s - 7:] = -1                       # padded tail: rows without keys
    kw = dict(window=window, softcap=softcap, causal=causal)
    _close(fa.flash_attention_cuda(q, k, v, p, p, **kw),
           blockwise_attention(q, k, v, p, p, block_k=16, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 12, 40])
@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
def test_expert_ffn_kernel(dev, dtype, c, gated, act):
    r = np.random.default_rng(c)
    p, d, f, e = 6, 96, 160, 4
    x = _randn(r, (p, c, d), dtype, dev)
    wg, wu = (_randn(r, (e, d, f), dtype, dev, 0.1) for _ in range(2))
    wd = _randn(r, (e, f, d), dtype, dev, 0.1)
    se = torch.tensor([0, 1, 2, 3, 1, -1], dtype=torch.int32, device=dev)
    cnt = torch.tensor([c, 0, 1, c, 2, 0], dtype=torch.int32, device=dev)
    wg = wg if gated else None
    got = mg.expert_ffn_cuda(x, wg, wu, wd, se, cnt, act=act)
    _close(got, mg.expert_ffn_plain(x, wg, wu, wd, se, cnt, act=act), dtype)
    assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("c,path", [(2, "skinny"), (12, "tensor_core"),
                                    (40, "tensor_core")])
def test_expert_ffn_bf16_rounds_once(dev, c, path):
    """In bfloat16 each path keeps float32 inside (hidden activation
    included) and rounds once, at the output: within half an ulp of the
    float32 plain version on the same inputs, plus summation order."""
    r = np.random.default_rng(c)
    p, d, f, e = 4, 64, 256, 3
    x = _randn(r, (p, c, d), torch.bfloat16, dev)
    wg, wu = (_randn(r, (e, d, f), torch.bfloat16, dev, 0.2)
              for _ in range(2))
    wd = _randn(r, (e, f, d), torch.bfloat16, dev, 0.2)
    se = torch.tensor([0, 2, 1, 2], dtype=torch.int32, device=dev)
    cnt = torch.tensor([c, 1, c, 0], dtype=torch.int32, device=dev)
    n = dict(mg.path_launches)
    got = mg.expert_ffn_cuda(x, wg, wu, wd, se, cnt)
    assert {k for k, v in mg.path_launches.items() if v != n[k]} == {path}
    want = mg.expert_ffn_plain(x.float(), wg.float(), wu.float(), wd.float(),
                               se, cnt)
    assert bool(((got.float() - want).abs() <=
                 1e-4 + 2.0 ** -8 * want.abs()).all())


@pytest.mark.parametrize("c", [4, 24])
def test_shadow_slot_is_bitwise_the_primary(dev, c):
    """A shadow slot that holds expert e computes bitwise what e's primary
    slot computes: the failover invariant at the kernel level, on the
    decode-shaped and the tensor-core paths."""
    r = np.random.default_rng(0)
    x = _randn(r, (1, c, 64), torch.bfloat16, dev).repeat(2, 1, 1)
    w = [_randn(r, (2, 64, 128), torch.bfloat16, dev, 0.1) for _ in range(2)]
    wd = _randn(r, (2, 128, 64), torch.bfloat16, dev, 0.1)
    se = torch.tensor([1, 1], dtype=torch.int32, device=dev)
    cnt = torch.tensor([c, c], dtype=torch.int32, device=dev)
    y = mg.expert_ffn_cuda(x, w[0], w[1], wd, se, cnt)
    assert torch.equal(y[0], y[1])


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros((1, 4, 48), device=dev)            # Dh 48: no kernel
    ck = torch.zeros((1, 8, 2, 48), device=dev)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ops.decode_attention(q, ck, ck, pos[:, None].expand(1, 8), q[:, :2],
                             q[:, :2], pos)
    with pytest.raises(TypeError):
        ops.expert_ffn(torch.zeros((1, 2, 8), device=dev,
                                   dtype=torch.float16),
                       None, torch.zeros((1, 8, 8), device=dev,
                                         dtype=torch.float16),
                       torch.zeros((1, 8, 8), device=dev,
                                   dtype=torch.float16),
                       torch.zeros((1,), dtype=torch.int32, device=dev),
                       torch.ones((1,), dtype=torch.int32, device=dev))
