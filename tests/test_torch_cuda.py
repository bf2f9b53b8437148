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
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import layers
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
@pytest.mark.parametrize("c", [2, 12, 40, 130])
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
    got = mg.expert_ffn_cuda(x, wg, wu, wd, se, cnt, decode=True,
                          act=act)
    _close(got, mg.expert_ffn_plain(x, wg, wu, wd, se, cnt, act=act), dtype)
    assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("c,path", [(2, "skinny"), (12, "tensor_core"),
                                    (40, "tensor_core"),
                                    (130, "tensor_core")])
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
    got = mg.expert_ffn_cuda(x, wg, wu, wd, se, cnt, decode=True)
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
    y = mg.expert_ffn_cuda(x, w[0], w[1], wd, se, cnt, decode=True)
    assert torch.equal(y[0], y[1])


def _paged_case(r, b, h, hkv, dh, nblk, pt, dtype, dev):
    """Page pools with a null page 0, rows that share a page and rows
    whose tail blocks are unmapped (null), and the gathered positions
    causal in every row's view."""
    npages = 1 + b * nblk
    pk, pv = (_randn(r, (npages, pt, hkv, dh), dtype, dev) for _ in range(2))
    q = _randn(r, (b, h, dh), dtype, dev)
    k1, v1 = (_randn(r, (b, hkv, dh), dtype, dev) for _ in range(2))
    bt = np.zeros((b, nblk), np.int32)
    ids = r.permutation(np.arange(1, npages)).astype(np.int32)
    pos = r.integers(pt, nblk * pt, size=(b,)).astype(np.int32)
    for i in range(b):
        used = -(-int(pos[i]) // pt)          # blocks holding [0, pos)
        bt[i, :used] = ids[i * nblk:i * nblk + used]
    if b > 1:
        bt[1, 0] = bt[0, 0]                   # a page two rows share
    ppos = np.full((npages, pt), -1, np.int32)
    for i in range(b):
        for j in range(nblk):
            if bt[i, j]:
                ppos[bt[i, j]] = np.arange(j * pt, (j + 1) * pt)
    ppos[0] = -1
    t = [torch.from_numpy(a).to(dev) for a in (ppos, bt, pos)]
    return q, pk, pv, t[0], t[1], k1, v1, t[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,dh", [(8, 8, 64), (16, 4, 128),
                                      (32, 8, 128)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_kernel_bitwise_the_fused_kernel(dev, dtype, h, hkv, dh,
                                               softcap):
    """The paged kernel shares the fused kernel's body, so on the same
    logical content (the pages gathered through the block table) the two
    are bitwise equal."""
    r = np.random.default_rng(h + dh)
    args = _paged_case(r, 3, h, hkv, dh, 8, 16, dtype, dev)
    q, pk, pv, ppos, bt, k1, v1, pos = args
    n = da.PAGED_KERNEL.launches
    got = ops.decode_attention_paged(*args, softcap=softcap)
    assert da.PAGED_KERNEL.launches == n + 1
    ck, cv, cpos = da.gather_pages(pk, pv, ppos, bt)
    want = da.decode_attention_cuda(q, ck, cv, cpos, k1, v1, pos,
                                    softcap=softcap)
    assert torch.equal(got, want)
    _close(got, da.decode_attention_paged_plain(*args, softcap=softcap),
           dtype)


def test_paged_kernel_refuses_what_it_does_not_take(dev):
    r = np.random.default_rng(0)
    q, pk, pv, ppos, bt, k1, v1, pos = _paged_case(
        r, 2, 8, 2, 64, 4, 16, torch.float32, dev)
    with pytest.raises(ValueError):                   # page of 6 tokens
        ops.decode_attention_paged(q, pk[:, :6].contiguous(),
                                   pv[:, :6].contiguous(),
                                   ppos[:, :6].contiguous(), bt, k1, v1, pos)
    with pytest.raises(ValueError):                   # bt rows != B
        ops.decode_attention_paged(q, pk, pv, ppos, bt[:1], k1, v1, pos)
    with pytest.raises(TypeError):                    # int64 block table
        ops.decode_attention_paged(q, pk, pv, ppos, bt.long(), k1, v1, pos)
    with pytest.raises(TypeError):                    # mixed dtypes
        ops.decode_attention_paged(q, pk.bfloat16(), pv, ppos, bt, k1, v1,
                                   pos)
    with pytest.raises(ValueError):                   # G = 3
        ops.decode_attention_paged(q[:, :6], pk, pv, ppos, bt, k1, v1, pos)


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
                       torch.ones((1,), dtype=torch.int32, device=dev),
                       decode=True)


# --------------------------------------------------------------------------
# Zamba2: the SSD scan, and attention at head dim 112
# --------------------------------------------------------------------------

def _scan_inputs(r, bs, s, h, p, n, dtype, dev):
    x = _randn(r, (bs, s, h, p), dtype, dev)
    dt = torch.nn.functional.softplus(_randn(r, (bs, s, h), torch.float32,
                                             dev))
    a = -torch.exp(_randn(r, (h,), torch.float32, dev, 0.5))
    b = _randn(r, (bs, s, n), torch.float32, dev, 0.3)
    c = _randn(r, (bs, s, n), torch.float32, dev, 0.3)
    return x, dt, a, b, c


@pytest.mark.parametrize("bs,s,h,p,n,chunk", [
    (1, 128, 112, 64, 64, 64),     # Zamba2-7B prefill of one prompt
    (2, 128, 3, 16, 32, 32),
    (2, 96, 1, 4, 8, 16),
    (1, 1, 8, 64, 64, 64),         # one step
    (1, 127, 4, 64, 64, 64),       # odd: the chunk halves down to 1
    (2, 21, 2, 16, 16, 64),        # odd: one chunk of 21
])
def test_ssm_scan_kernel(dev, bs, s, h, p, n, chunk):
    """float32 within 2e-4 of the plain chunked scan (the bar the Pallas
    kernel is held to), on the kernel's every path through S and T."""
    r = np.random.default_rng(s + h)
    args = _scan_inputs(r, bs, s, h, p, n, torch.float32, dev)
    launches = ss.KERNEL.launches
    y, hf = ops.ssm_scan(*args, chunk=chunk)
    assert ss.KERNEL.launches == launches + 1
    wy, wh = kref.ssm_scan_chunked_ref(*args, chunk=chunk)
    torch.testing.assert_close(y, wy, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(hf, wh, rtol=2e-4, atol=2e-4)
    sy, sh = kref.ssm_scan_ref(*args)
    torch.testing.assert_close(y, sy, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(hf, sh, rtol=2e-4, atol=2e-4)


def test_ssm_scan_kernel_bf16_rounds_once(dev):
    """bfloat16 x: float32 inside, one rounding of y at the output."""
    r = np.random.default_rng(1)
    args = _scan_inputs(r, 1, 128, 112, 64, 64, torch.bfloat16, dev)
    y, hf = ss.ssm_scan_cuda(*args, chunk=64)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    wy, wh = kref.ssm_scan_chunked_ref(args[0].float(), *args[1:], chunk=64)
    assert bool(((y.float() - wy).abs() <= 1e-4 + 2.0 ** -8 * wy.abs()).all())
    torch.testing.assert_close(hf, wh, rtol=2e-4, atol=2e-4)


def test_ssm_scan_refuses_what_it_does_not_take(dev):
    r = np.random.default_rng(0)
    x, dt, a, b, c = _scan_inputs(r, 1, 8, 2, 128, 16, torch.float32, dev)
    with pytest.raises(ValueError):                  # P 128 > 64
        ss.ssm_scan_cuda(x, dt, a, b, c)
    with pytest.raises(ValueError):                  # dt rows != S
        ss.ssm_scan_cuda(x[:, :, :, :16], dt[:, :4], a, b, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sc", [(8, 32, 256), (2, 4, 33)])
def test_decode_attention_head_dim_112(dev, dtype, b, h, sc):
    r = np.random.default_rng(sc)
    dh = 112
    q = _randn(r, (b, h, dh), dtype, dev)
    ck, cv = (_randn(r, (b, sc, h, dh), dtype, dev) for _ in range(2))
    k1, v1 = (_randn(r, (b, h, dh), dtype, dev) for _ in range(2))
    pos = torch.tensor(r.integers(1, sc, size=(b,)), dtype=torch.int32,
                       device=dev)
    ar = torch.arange(sc, device=dev, dtype=torch.int32)[None]
    cpos = torch.where(ar < pos[:, None], ar, torch.full_like(ar, -1))
    args = (q, ck, cv, cpos, k1, v1, pos)
    _close(ops.decode_attention(*args), da.decode_attention_plain(*args),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h", [(1, 128, 32), (2, 40, 4)])
def test_flash_attention_head_dim_112(dev, dtype, b, s, h):
    r = np.random.default_rng(s)
    dh = 112
    q = _randn(r, (b, s, h, dh), dtype, dev)
    k, v = (_randn(r, (b, s, h, dh), dtype, dev) for _ in range(2))
    p = torch.arange(s, device=dev, dtype=torch.int32).repeat(b, 1)
    _close(ops.full_attention(q, k, v, p, p),
           blockwise_attention(q, k, v, p, p, block_k=16), dtype)


# --------------------------------------------------------------------------
# row invariance: a token's bits in a prefill or chunk call do not depend
# on how many rows share the call (chunked == whole-prompt prefill)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 8)])
def test_blocked_projection_and_norm_rows_do_not_depend_on_m(dev, k, n):
    r = np.random.default_rng(n)
    w = _randn(r, (k, n), torch.bfloat16, dev, k ** -0.5)
    scale = {"scale": _randn(r, (k,), torch.float32, dev)}
    x = _randn(r, (1024 + 64, k), torch.bfloat16, dev)
    ref = layers.matmul(x, w, True)
    ref_n = layers.norm(scale, x, 1e-6, True)
    for m, off in ((8, 0), (8, 77), (64, 200), (128, 5), (1024, 64)):
        rows = x[off:off + m]
        assert torch.equal(layers.matmul(rows, w, True), ref[off:off + m])
        assert torch.equal(layers.norm(scale, rows, 1e-6, True),
                           ref_n[off:off + m])


def test_expert_ffn_prefill_path_rows_do_not_depend_on_c(dev):
    """A prefill or chunk call (decode=False) takes the tensor-core path
    at every C, and a token's row has the same bits whatever C and
    whichever row of its slot it rides."""
    r = np.random.default_rng(2)
    d, f = 256, 512
    wg, wu = (_randn(r, (2, d, f), torch.bfloat16, dev, d ** -0.5)
              for _ in range(2))
    wd = _randn(r, (2, f, d), torch.bfloat16, dev, f ** -0.5)
    se = torch.tensor([1], dtype=torch.int32, device=dev)
    xs = _randn(r, (1, 256, d), torch.bfloat16, dev)

    def ffn(x):
        cnt = torch.tensor([x.shape[1]], dtype=torch.int32, device=dev)
        n = dict(mg.path_launches)
        y = ops.expert_ffn(x, wg, wu, wd, se, cnt, decode=False)
        assert {k for k, v in mg.path_launches.items()
                if v != n[k]} == {"tensor_core"}
        return y
    ref = ffn(xs)
    for c, off in ((2, 0), (2, 131), (4, 60), (8, 3), (128, 100),
                   (256, 0)):
        assert torch.equal(ffn(xs[:, off:off + c].contiguous()),
                           ref[:, off:off + c])


@pytest.mark.parametrize("c", [2, 4])
def test_expert_ffn_prefill_path_small_c_rounds_once(dev, c):
    r = np.random.default_rng(c)
    p, d, f, e = 4, 64, 256, 3
    x = _randn(r, (p, c, d), torch.bfloat16, dev)
    wg, wu = (_randn(r, (e, d, f), torch.bfloat16, dev, 0.2)
              for _ in range(2))
    wd = _randn(r, (e, f, d), torch.bfloat16, dev, 0.2)
    se = torch.tensor([0, 2, 1, 2], dtype=torch.int32, device=dev)
    cnt = torch.tensor([c, 1, c, 0], dtype=torch.int32, device=dev)
    got = mg.expert_ffn_cuda(x, wg, wu, wd, se, cnt, decode=False)
    want = mg.expert_ffn_plain(x.float(), wg.float(), wu.float(), wd.float(),
                               se, cnt)
    assert bool(((got.float() - want).abs() <=
                 1e-4 + 2.0 ** -8 * want.abs()).all())
