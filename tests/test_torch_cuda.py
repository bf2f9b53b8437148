"""The port's CUDA kernels against their plain PyTorch versions, on the
card. CUDA kernels have no CPU mode, so every test here needs an NVIDIA
GPU and nvcc, and skips elsewhere. On a GPU machine (which need not have
JAX, so conftest.py is left out):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bits
from repro_torch.kernels import build as kbuild
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
                                    (130, "tensor_core"), (8, "skinny")])
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


@pytest.mark.parametrize("c", [4, 24, 1, 8])
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


def _decode_ffn_case(r, dev, d=256, f=512, e=3):
    """A bf16 bank of e experts at widths (d, f) that take the decode
    path's ragged column tiles (f not a multiple of 128)."""
    wg, wu = (_randn(r, (e, d, f), torch.bfloat16, dev, d ** -0.5)
              for _ in range(2))
    wd = _randn(r, (e, f, d), torch.bfloat16, dev, f ** -0.5)
    return wg, wu, wd


def _decode_ffn(x, wg, wu, wd, se, cnt):
    n = dict(mg.path_launches)
    y = mg.expert_ffn_cuda(x, wg, wu, wd, se, cnt, decode=True)
    assert {k for k, v in mg.path_launches.items() if v != n[k]} == \
        {"skinny"}
    return y


def test_decode_ffn_row_bits_do_not_depend_on_c_or_its_row(dev):
    """The decode path (bf16, C <= 8) pads C to 8 and takes one product
    shape and one k order: a token's row has the same bits alone and in a
    slot of any C from 1 to 8, at every row index, whatever the other
    rows hold."""
    r = np.random.default_rng(7)
    wg, wu, wd = _decode_ffn_case(r, dev, d=264, f=712)
    se = torch.tensor([2], dtype=torch.int32, device=dev)
    tok = _randn(r, (1, 1, 264), torch.bfloat16, dev)
    alone = _decode_ffn(tok, wg, wu, wd, se,
                        torch.ones(1, dtype=torch.int32, device=dev))
    for c in range(1, 9):
        for row in range(c):
            x = _randn(r, (1, c, 264), torch.bfloat16, dev)
            x[0, row] = tok[0, 0]
            cnt = torch.full((1,), c, dtype=torch.int32, device=dev)
            y = _decode_ffn(x, wg, wu, wd, se, cnt)
            assert torch.equal(y[0, row], alone[0, 0]), (c, row)


def test_decode_ffn_live_pattern_changes_no_bits(dev):
    """16 slots (shadows of the primaries, a -1 slot) in one call: under
    every pattern of live and empty slots tried (each slot alone, each
    left out, all, none, alternating and 24 drawn at random), a live
    slot's rows have the bits of the all-live call and an empty slot's
    (counts 0) are exact zeros."""
    r = np.random.default_rng(8)
    wg, wu, wd = _decode_ffn_case(r, dev, e=4)
    se = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3, -1, 1, 2, 3],
                      dtype=torch.int32, device=dev)
    x = _randn(r, (16, 4, 256), torch.bfloat16, dev)
    full = _decode_ffn(x, wg, wu, wd, se,
                       torch.full((16,), 4, dtype=torch.int32, device=dev))
    eye = np.eye(16, dtype=bool)
    pats = list(eye) + list(~eye) + [np.ones(16, bool), np.zeros(16, bool),
                                     np.arange(16) % 2 == 0]
    pats += list(r.random((24, 16)) < 0.5)
    for live in pats:
        cnt = torch.from_numpy(np.where(live, 4, 0).astype(np.int32)).to(dev)
        y = _decode_ffn(x, wg, wu, wd, se, cnt)
        for p_ in range(16):
            if live[p_]:
                assert torch.equal(y[p_], full[p_]), (live, p_)
            else:
                assert not y[p_].float().abs().max().item(), (live, p_)
    # a shadow slot gives its primary's bits, -1 reads expert 0
    x = x[:1].repeat(16, 1, 1)
    y = _decode_ffn(x, wg, wu, wd, se,
                    torch.full((16,), 4, dtype=torch.int32, device=dev))
    for p_ in range(4, 16):
        assert torch.equal(y[p_], y[max(int(se[p_]), 0)])


def test_decode_ffn_runs_streams_and_graphs_agree(dev):
    """Two runs, two streams at once, and a replayed CUDA graph give the
    decode path the same bits (the down pass is a programmatic dependent
    launch of the gate/up pass; nothing is shared between calls)."""
    r = np.random.default_rng(9)
    wg, wu, wd = _decode_ffn_case(r, dev, d=512, f=1024, e=4)
    se = torch.tensor([0, 1, 2, 3, 0, 1], dtype=torch.int32, device=dev)
    cases = []
    for c in (2, 8):
        x = _randn(r, (6, c, 512), torch.bfloat16, dev)
        cases.append((x, torch.tensor([c, c, 0, c, 1, c], dtype=torch.int32,
                                      device=dev)))
    want = [_decode_ffn(x, wg, wu, wd, se, cnt) for x, cnt in cases]
    assert all(torch.equal(w, _decode_ffn(x, wg, wu, wd, se, cnt))
               for w, (x, cnt) in zip(want, cases))
    streams = [torch.cuda.Stream() for _ in cases]
    torch.cuda.synchronize()
    for _ in range(10):
        got = []
        for st, (x, cnt) in zip(streams, cases):
            with torch.cuda.stream(st):
                got.append(_decode_ffn(x, wg, wu, wd, se, cnt))
        torch.cuda.synchronize()
        assert all(torch.equal(w, g) for w, g in zip(want, got))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [_decode_ffn(x, wg, wu, wd, se, cnt) for x, cnt in cases]
    for _ in range(3):
        for o in outs:
            o.fill_(1.0)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(w, o) for w, o in zip(want, outs))


@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_decode_ffn_rounds_once_at_mixtral_widths(dev, c):
    """bf16 within half an ulp + 1e-4 of the float32 plain version at
    Mixtral-8x7B's widths (D 4096, F 14336, 16 slots, 8 live), on the
    live slots (the float32 bank is held only for them)."""
    g = torch.Generator(device="cuda").manual_seed(c)
    d, f = 4096, 14336
    bank = [(torch.randn((8, d, f), generator=g, device="cuda") *
             d ** -0.5).bfloat16() for _ in range(2)]
    wdn = (torch.randn((8, f, d), generator=g, device="cuda") *
           f ** -0.5).bfloat16()
    se = torch.tensor(list(range(8)) + [0, 1, 2, 3] * 2, dtype=torch.int32,
                      device="cuda")
    cnt = torch.tensor([c] * 8 + [0] * 8, dtype=torch.int32, device="cuda")
    x = torch.randn((16, c, d), generator=g, device="cuda").bfloat16()
    got = _decode_ffn(x, bank[0], bank[1], wdn, se, cnt)
    assert not got[8:].float().abs().max().item()
    want = mg.expert_ffn_plain(x[:8].float(), bank[0].float(),
                               bank[1].float(), wdn.float(), se[:8], cnt[:8])
    assert bool(((got[:8].float() - want).abs() <=
                 1e-4 + 2.0 ** -8 * want.abs()).all())


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
    (1, 64, 4, 64, 64, 64),        # one full chunk
    (2, 192, 4, 64, 64, 64),       # three chunks
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


@pytest.mark.parametrize("s", [128, 1, 64, 127, 192])
def test_ssm_scan_kernel_bf16_rounds_once(dev, s):
    """bfloat16 x: float32 inside, one rounding of y at the output."""
    r = np.random.default_rng(1)
    args = _scan_inputs(r, 1, s, 112, 64, 64, torch.bfloat16, dev)
    y, hf = ss.ssm_scan_cuda(*args, chunk=64)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    wy, wh = kref.ssm_scan_chunked_ref(args[0].float(), *args[1:], chunk=64)
    assert bool(((y.float() - wy).abs() <= 1e-4 + 2.0 ** -8 * wy.abs()).all())
    torch.testing.assert_close(hf, wh, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [127, 192])
def test_ssm_scan_rows_do_not_depend_on_the_call(dev, dtype, s):
    """The chunks of a (b, h) run side by side in one cluster: y and the
    final state of each (b, h) have the same bits whatever B and H of the
    call (each (b, h) alone against the whole call)."""
    r = np.random.default_rng(s)
    bs, h = 3, 5
    x, dt, a, b, c = _scan_inputs(r, bs, s, h, 64, 64, dtype, dev)
    y, hf = ss.ssm_scan_cuda(x, dt, a, b, c)
    for i in range(bs):
        for j in range(h):
            yi, hi = ss.ssm_scan_cuda(
                x[i:i + 1, :, j:j + 1].contiguous(),
                dt[i:i + 1, :, j:j + 1].contiguous(), a[j:j + 1].contiguous(),
                b[i:i + 1].contiguous(), c[i:i + 1].contiguous())
            assert torch.equal(yi[0, :, 0], y[i, :, j])
            assert torch.equal(hi[0, 0], hf[i, j])


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


@pytest.mark.parametrize("c", [63, 64, 65, 200])
def test_expert_ffn_rows_keep_their_bits_across_tile_shapes(dev, c):
    """C <= 64 takes the streaming tiles (one 64-row M tile, two
    warpgroups side by side in N), larger C the compute tiles (two M
    tiles): one instruction shape and one k order, so a row has the same
    bits either way, with ragged D and F (not multiples of the tiles)."""
    r = np.random.default_rng(c)
    d, f = 200, 344
    wg, wu = (_randn(r, (2, d, f), torch.bfloat16, dev, d ** -0.5)
              for _ in range(2))
    wd = _randn(r, (2, f, d), torch.bfloat16, dev, f ** -0.5)
    se = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    xs = _randn(r, (2, 256, d), torch.bfloat16, dev)

    def ffn(x):
        cnt = torch.full((2,), x.shape[1], dtype=torch.int32, device=dev)
        return ops.expert_ffn(x, wg, wu, wd, se, cnt, decode=False)
    ref = ffn(xs)
    off = 256 - c
    assert torch.equal(ffn(xs[:, off:].contiguous()), ref[:, off:])


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


# --------------------------------------------------------------------------
# the dense sliding-window and softcap family: head dims 80 and 256, group
# size 6, and the partial kernel
# --------------------------------------------------------------------------

# (H, Hkv, Dh): Gemma2-2B, H2O-Danube-1.8B, Qwen2-1.5B, the (Dh, G) pairs
# built for the partial kernel and added for the fused and paged ones, and
# Mixtral-8x7B's, which the partial kernel was built for later
NEW_HEADS = [(8, 4, 256), (32, 8, 80), (12, 2, 128), (32, 8, 128)]


def _decode_case(r, b, h, hkv, dh, sc, dtype, dev):
    q = _randn(r, (b, h, dh), dtype, dev)
    ck, cv = (_randn(r, (b, sc, hkv, dh), dtype, dev) for _ in range(2))
    k1, v1 = (_randn(r, (b, hkv, dh), dtype, dev) for _ in range(2))
    pos = torch.tensor(r.integers(1, sc, size=(b,)), dtype=torch.int32,
                       device=dev)
    ar = torch.arange(sc, device=dev, dtype=torch.int32)[None]
    cpos = torch.where(ar < pos[:, None], ar, torch.full_like(ar, -1))
    return q, ck, cv, cpos, k1, v1, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,dh", NEW_HEADS)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 50.0)])
def test_decode_kernels_at_new_heads(dev, dtype, h, hkv, dh, window,
                                     softcap):
    """Fused and partial kernels against their plain versions; the
    partials combined against the fused kernel; a row with no valid key
    gives the plain version's partials (m = -1e30, l = 0, acc = 0)."""
    r = np.random.default_rng(h * dh + window)
    q, ck, cv, cpos, k1, v1, pos = _decode_case(r, 3, h, hkv, dh, 70,
                                                dtype, dev)
    pos[0] = -1
    kw = dict(window=window, softcap=softcap)
    fused = ops.decode_attention(q, ck, cv, cpos, k1, v1, pos, **kw)
    _close(fused, da.decode_attention_plain(q, ck, cv, cpos, k1, v1, pos,
                                            **kw), dtype)
    n = da.PARTIAL_KERNEL.launches
    m, l, acc = ops.decode_attention_partial(q, ck, cv, cpos, pos, **kw)
    assert da.PARTIAL_KERNEL.launches == n + 1
    assert m.dtype == l.dtype == acc.dtype == torch.float32
    want = da.decode_attention_partial_plain(q, ck, cv, cpos, pos, **kw)
    for got, w in zip((m, l, acc), want):
        torch.testing.assert_close(got, w, rtol=2e-5, atol=2e-5)
    assert bool((m[0] == -1e30).all()) and not l[0].any() and \
        not acc[0].any()
    _close(da.combine_decode_partials(q, m, l, acc, k1, v1, softcap=softcap),
           fused, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,dh", NEW_HEADS)
def test_paged_kernel_at_new_heads(dev, dtype, h, hkv, dh):
    r = np.random.default_rng(h + dh)
    args = _paged_case(r, 3, h, hkv, dh, 8, 16, dtype, dev)
    q, pk, pv, ppos, bt, k1, v1, pos = args
    got = ops.decode_attention_paged(*args, softcap=50.0)
    ck, cv, cpos = da.gather_pages(pk, pv, ppos, bt)
    assert torch.equal(got, da.decode_attention_cuda(
        q, ck, cv, cpos, k1, v1, pos, softcap=50.0))
    _close(got, da.decode_attention_paged_plain(*args, softcap=50.0), dtype)


@pytest.mark.parametrize("h,hkv,dh,partial_only", [
    (8, 1, 256, False),          # G 8 at Dh 256: neither kernel
    (6, 1, 80, False),           # G 6 at Dh 80: neither kernel
    (16, 8, 128, True)])         # G 2 at Dh 128: fused and paged only
def test_decode_kernels_refuse_pairs_not_built(dev, h, hkv, dh,
                                               partial_only):
    r = np.random.default_rng(0)
    args = _decode_case(r, 1, h, hkv, dh, 8, torch.float32, dev)
    if not partial_only:
        with pytest.raises(ValueError):
            ops.decode_attention(*args)
    q, ck, cv, cpos, _, _, pos = args
    with pytest.raises(ValueError):
        ops.decode_attention_partial(q, ck, cv, cpos, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,dh", [(1, 100, 8, 4, 256),
                                          (2, 70, 32, 8, 80),
                                          (2, 45, 12, 2, 128)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 50.0)])
def test_flash_attention_at_new_heads(dev, dtype, b, s, h, hkv, dh, window,
                                      softcap):
    r = np.random.default_rng(s + dh)
    q = _randn(r, (b, s, h, dh), dtype, dev)
    k, v = (_randn(r, (b, s, hkv, dh), dtype, dev) for _ in range(2))
    p = torch.arange(s, device=dev, dtype=torch.int32).repeat(b, 1)
    p[-1, s - 7:] = -1                       # padded tail: rows without keys
    kw = dict(window=window, softcap=softcap)
    _close(ops.full_attention(q, k, v, p, p, **kw),
           blockwise_attention(q, k, v, p, p, block_k=16, **kw), dtype)


# --------------------------------------------------------------------------
# Granite-34B's decode attention (MQA: 48 query heads on one KV head), and
# the expert FFN's decode path past 512 slots (Kimi-K2 on 2 EWs: 768)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_at_g48(dev, dtype):
    """Fused and paged decode at (Dh 128, G 48), the head groups of 8 that
    a block takes, against the plain versions over a 300-position cache
    (three splits in bf16); paged bitwise the fused kernel on the gathered
    pages; the launches counted once a call."""
    r = np.random.default_rng(48)
    args = _decode_case(r, 3, 48, 1, 128, 300, dtype, dev)
    n = da.KERNEL.launches
    got = ops.decode_attention(*args)
    assert da.KERNEL.launches == n + 1
    _close(got, da.decode_attention_plain(*args), dtype)
    pargs = _paged_case(r, 3, 48, 1, 128, 19, 16, dtype, dev)
    q, pk, pv, ppos, bt, k1, v1, pos = pargs
    n = da.PAGED_KERNEL.launches
    paged = ops.decode_attention_paged(*pargs)
    assert da.PAGED_KERNEL.launches == n + 1
    _close(paged, da.decode_attention_paged_plain(*pargs), dtype)
    ck, cv, cpos = da.gather_pages(pk, pv, ppos, bt)
    assert torch.equal(paged, da.decode_attention_cuda(q, ck, cv, cpos, k1,
                                                       v1, pos))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fused", "paged"])
def test_decode_g48_is_six_g8_calls(dev, dtype, kind):
    """A head's running max, sums and order of sums depend only on its own
    q: the G-48 call gives bitwise the outputs of six G-8 calls on the six
    head slices, over the same K/V, in both bodies (bf16 over 600
    positions: five splits, and a merge ticket per head group)."""
    r = np.random.default_rng(6)
    if kind == "fused":
        args = list(_decode_case(r, 4, 48, 1, 128, 600, dtype, dev))
        fn = ops.decode_attention
    else:
        args = list(_paged_case(r, 4, 48, 1, 128, 38, 16, dtype, dev))
        fn = ops.decode_attention_paged
    whole = fn(*args)
    q = args[0]
    for i in range(6):
        part = fn(q[:, 8 * i:8 * i + 8].contiguous(), *args[1:])
        assert torch.equal(whole[:, 8 * i:8 * i + 8], part), i


def _bank(g, e, rows, cols):
    """A bf16 bank [e, rows, cols] of N(0, 1 / rows) draws, 16 experts at a
    time (Kimi-K2's whole bank in float32 would be 22.5 GB)."""
    w = torch.empty((e, rows, cols), dtype=torch.bfloat16, device="cuda")
    for i in range(0, e, 16):
        w[i:i + 16] = torch.randn((min(16, e - i), rows, cols), generator=g,
                                  device="cuda").mul_(rows ** -0.5)
    return w


def test_decode_ffn_at_768_slots(dev):
    """The bf16 decode path at P 768 (Kimi-K2's 384 primaries and 384
    shadows on 2 EWs) on Kimi's whole bank (384 experts at D 7168, F 2048:
    5.6 G elements a tensor, an expert's offset past 2^31 elements from
    expert 147 on): it takes the decode path ("skinny"), the live slots
    (experts 146, 147, 316 and 376-383) match the plain version and hold
    half an ulp + 1e-4 of the float32 one, empty slots give exact zeros,
    and a shadow slot's rows are bitwise its primary's. The tensor-core
    path matches the plain version on the same slots."""
    g = torch.Generator(device="cuda").manual_seed(768)
    d, f, e, p, c = 7168, 2048, 384, 768, 2
    wg, wu = (_bank(g, e, d, f) for _ in range(2))
    wd = _bank(g, e, f, d)
    se = torch.arange(p, device="cuda", dtype=torch.int32) % e
    last = torch.arange(e - 8, e, device="cuda", dtype=torch.int32)
    se[:8] = se[384:392] = last           # primaries on 376..383, shadows
    live = torch.zeros(p, dtype=torch.bool, device="cuda")
    live[:8] = live[384:392] = True
    live[[146, 147, 700]] = True          # experts 146, 147 and 316
    cnt = torch.where(live, c, 0).to(torch.int32)
    x = torch.randn((p, c, d), generator=g, device="cuda").bfloat16()
    x[384:392] = x[:8]
    got = _decode_ffn(x, wg, wu, wd, se, cnt)
    assert mg.last_path == "skinny"
    idx = live.nonzero().flatten()
    want = mg.expert_ffn_plain(x[idx], wg, wu, wd, se[idx], cnt[idx])
    _close(got[idx], want, torch.bfloat16)
    want32 = mg.expert_ffn_plain(x[:8].float(), wg[e - 8:].float(),
                                 wu[e - 8:].float(), wd[e - 8:].float(),
                                 se[:8] - (e - 8), cnt[:8])
    assert bool(((got[:8].float() - want32).abs() <=
                 1e-4 + 2.0 ** -8 * want32.abs()).all())
    assert torch.equal(got[384:392], got[:8])
    assert not got[~live].float().abs().max().item()
    # every slot live: the live list holds all 768
    full = _decode_ffn(x, wg, wu, wd, se, torch.full((p,), c,
                                                     dtype=torch.int32,
                                                     device="cuda"))
    assert torch.equal(full[idx], got[idx])
    tc = mg.expert_ffn_cuda(x, wg, wu, wd, se, cnt, decode=False)
    assert mg.last_path == "tensor_core"
    _close(tc[idx], want, torch.bfloat16)
    assert not tc[~live].float().abs().max().item()


def test_decode_ffn_tensor_maps_are_kept_for_72_banks(dev):
    """72 banks (a whole Qwen1.5-MoE-A2.7B: 24 layers x 3) through the
    decode path twice: the second pass makes no tensor map."""
    r = np.random.default_rng(72)
    banks = [_decode_ffn_case(r, dev, d=256, f=256, e=2) for _ in range(24)]
    se = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    cnt = torch.tensor([1, 1], dtype=torch.int32, device=dev)
    x = _randn(r, (2, 1, 256), torch.bfloat16, dev)
    for wg, wu, wd in banks:
        _decode_ffn(x, wg, wu, wd, se, cnt)
    n = mg.tensor_maps_encoded()
    for wg, wu, wd in banks:
        _decode_ffn(x, wg, wu, wd, se, cnt)
    assert mg.tensor_maps_encoded() == n


def test_route_gates_do_not_depend_on_the_call(dev):
    """Qwen1.5-MoE's routing (60 experts top-4 on 8 EWs, 80 slots): a
    token's experts, gate weights (softmax over 60, a sum over 4) and
    slots have the same bits in a 128-token call and inside a 1,024-token
    call, so a chunk call routes its tokens as whole-prompt prefill
    does."""
    from repro_torch.core import ert, refe
    pl = ert.default_placement(60, 8)
    rs = refe.RouteState.healthy(pl, 2, device=dev)
    r = np.random.default_rng(60)
    logits = _randn(r, (1024, 60), torch.bfloat16, dev)
    x = torch.zeros((1024, 8), dtype=torch.bfloat16, device=dev)

    def route(n):
        return refe.route(x[:n], logits[:n], rs, pl, top_k=4,
                          capacity_factor=4.0, capacity=n)
    small, big = route(128), route(1024)
    for k in ("topk_idx", "gate_w", "slot_idx"):
        assert torch.equal(small[k], big[k][:128]), k


# --------------------------------------------------------------------------
# the flash kernel's tensor-core path (bfloat16)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("dh", [32, 64, 80, 112, 128, 256])
def test_flash_tensor_core_row_bits_do_not_depend_on_the_call(dev, dh, g):
    """bf16 flash with a window and a softcap, at every head dim the
    kernel is built for: every row is within half a bf16 ulp + 1e-4 of the
    float32 plain version, and a row has the same bits in a whole-prompt
    call and in a chunk call over a cache view padded to another Sk beside
    idle batch rows, whether it is row 0, 63 or 127 of its query tile."""
    r = np.random.default_rng(dh * 10 + g)
    hkv, s, sk, c, target = 2, 300, 384, 136, 150
    h = g * hkv
    kw = dict(window=72, softcap=30.0)
    q = _randn(r, (1, s, h, dh), torch.bfloat16, dev)
    k, v = (_randn(r, (1, s, hkv, dh), torch.bfloat16, dev)
            for _ in range(2))
    pos = torch.arange(s, device=dev, dtype=torch.int32)[None]
    n = dict(fa.path_launches)
    whole = ops.full_attention(q, k, v, pos, pos, **kw)
    assert fa.path_launches["tensor_core"] == n["tensor_core"] + 1
    want = blockwise_attention(q.float(), k.float(), v.float(), pos, pos,
                               block_k=16, **kw)
    assert bool(((whole.float() - want).abs() <=
                 1e-4 + 2.0 ** -8 * want.abs()).all())
    # batch row 1 is the prompt's cache view; rows 0 and 2 are idle (no
    # query position) beside live keys
    ck, cv = (_randn(r, (3, sk, hkv, dh), torch.bfloat16, dev)
              for _ in range(2))
    ck[1, :s], cv[1, :s] = k[0], v[0]
    ar = torch.arange(sk, device=dev, dtype=torch.int32)
    for row in (0, 63, 127):
        # the chunk [c0, c0 + c) that puts (target, row % g) at local row
        # `row` of the call's first query tile
        c0 = target - row // g
        kp = torch.where(ar < 90, ar, torch.full_like(ar, -1)).repeat(3, 1)
        kp[1] = torch.where(ar < c0 + c, ar, torch.full_like(ar, -1))
        qp = torch.full((3, c), -1, device=dev, dtype=torch.int32)
        qp[1] = torch.arange(c0, c0 + c, device=dev, dtype=torch.int32)
        qc = _randn(r, (3, c, h, dh), torch.bfloat16, dev)
        qc[1] = q[0, c0:c0 + c]
        out = ops.full_attention(qc, ck, cv, qp, kp, **kw)
        assert torch.equal(out[1], whole[0, c0:c0 + c])
        assert not out[0].any() and not out[2].any()


def test_flash_path_counts(dev):
    """bfloat16 takes the tensor-core path and float32 the CUDA-core
    path; each launch counts once in KERNEL.launches and once in its
    path."""
    r = np.random.default_rng(0)
    p = torch.arange(40, device=dev, dtype=torch.int32)[None]
    for dtype, path in ((torch.bfloat16, "tensor_core"),
                        (torch.float32, "cuda_core")):
        q = _randn(r, (1, 40, 8, 64), dtype, dev)
        k, v = (_randn(r, (1, 40, 2, 64), dtype, dev) for _ in range(2))
        n, paths = fa.KERNEL.launches, dict(fa.path_launches)
        ops.full_attention(q, k, v, p, p)
        assert fa.KERNEL.launches == n + 1
        assert {key for key, val in fa.path_launches.items()
                if val != paths[key]} == {path}


def test_ring_restore_keeps_the_highest_token_on_the_card(dev):
    """Every slot of a ring layer restored from two tokens, t and t + Sc,
    given highest first: each slot keeps token t + Sc's K/V and position
    (a scatter with repeated indices would pick no defined winner)."""
    from repro_torch.serving.kvcache import CacheLayout
    sc, hkv, dh = 64, 2, 32
    cache = {"layers": [{
        "k": torch.zeros((2, sc, hkv, dh), device=dev),
        "v": torch.zeros((2, sc, hkv, dh), device=dev),
        "pos": torch.full((2, sc), -1, dtype=torch.int32, device=dev)}]}
    tokens = list(range(2 * sc - 1, -1, -1))
    g = torch.Generator().manual_seed(0)
    segs = [[torch.randn((1, 2, hkv, dh), generator=g),
             torch.full((1,), t, dtype=torch.int32)] for t in tokens]
    CacheLayout().write_token_segments(cache, 1, tokens, segs)
    layer = cache["layers"][0]
    assert layer["pos"][1].tolist() == list(range(sc, 2 * sc))
    for t, seg in zip(tokens[:sc], segs[:sc]):
        assert torch.equal(layer["k"][1, t % sc].cpu(), seg[0][0, 0])
        assert torch.equal(layer["v"][1, t % sc].cpu(), seg[0][0, 1])


# --------------------------------------------------------------------------
# the split body of the bf16 fused and paged decode kernels
# --------------------------------------------------------------------------

# every (Dh, G) the fused and paged kernels are built for
DECODE_PAIRS = [(dh, g) for dh in (32, 64, 112, 128) for g in (1, 2, 4, 8)] \
    + [(80, 4), (128, 6), (256, 2)]


def _bf16(r, shape, dev):
    return _randn(r, shape, torch.bfloat16, dev)


def _causal(sc, pos, dev):
    ar = torch.arange(sc, device=dev, dtype=torch.int32)[None]
    return torch.where(ar < pos[:, None], ar, torch.full_like(ar, -1))


@pytest.mark.parametrize("dh,g", DECODE_PAIRS)
def test_decode_row_bits_do_not_depend_on_the_call(dev, dh, g):
    """A row's bf16 output has the same bits alone, inside a batch of 8
    rows of its length, inside a batch whose other rows have other
    lengths, in a cache with a larger Sc (the extra positions masked) and
    through a block table over 16-token pages in a shuffled order."""
    r = np.random.default_rng(dh * 10 + g)
    hkv, sc, n, row = 2, 600, 530, 5
    h = g * hkv
    q = _bf16(r, (8, h, dh), dev)
    ck, cv = (_bf16(r, (8, sc, hkv, dh), dev) for _ in range(2))
    k1, v1 = (_bf16(r, (8, hkv, dh), dev) for _ in range(2))
    kw = dict(softcap=30.0)

    def one(pos, ck=ck, cv=cv, sc=sc):
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        return ops.decode_attention(q, ck, cv, _causal(sc, pos, dev), k1, v1,
                                    pos, **kw)
    lens = [int(x) for x in r.integers(1, sc, size=8)]
    lens[row] = n
    alone = ops.decode_attention(
        q[row:row + 1], ck[row:row + 1], cv[row:row + 1],
        _causal(sc, torch.tensor([n], dtype=torch.int32, device=dev), dev),
        k1[row:row + 1], v1[row:row + 1],
        torch.tensor([n], dtype=torch.int32, device=dev), **kw)
    assert torch.equal(one([n] * 8)[row], alone[0])
    assert torch.equal(one(lens)[row], alone[0])
    big = 1500
    ckb, cvb = (torch.cat([c, _bf16(r, (8, big - sc, hkv, dh), dev)], 1)
                for c in (ck, cv))
    assert torch.equal(one(lens, ckb, cvb, big)[row], alone[0])
    # the same logical rows through a block table (pages shuffled)
    pt = 16
    nblk = -(-sc // pt)
    order = torch.from_numpy(r.permutation(8 * nblk) + 1).to(dev)
    bt = order.view(8, nblk).int()
    pk = torch.zeros((1 + 8 * nblk, pt, hkv, dh), dtype=torch.bfloat16,
                     device=dev)
    pv = torch.zeros_like(pk)
    ppos = torch.full((1 + 8 * nblk, pt), -1, dtype=torch.int32, device=dev)
    pad = nblk * pt - sc
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    cpos = torch.cat([_causal(sc, pos, dev),
                      torch.full((8, pad), -1, dtype=torch.int32,
                                 device=dev)], 1)
    for c, pool in ((ck, pk), (cv, pv)):
        full = torch.cat([c, torch.zeros((8, pad, hkv, dh), dtype=c.dtype,
                                         device=dev)], 1)
        pool[bt.reshape(-1).long()] = full.reshape(8 * nblk, pt, hkv, dh)
    ppos[bt.reshape(-1).long()] = cpos.reshape(8 * nblk, pt)
    n0 = da.PAGED_KERNEL.launches
    paged = ops.decode_attention_paged(q, pk, pv, ppos, bt, k1, v1, pos,
                                       **kw)
    assert da.PAGED_KERNEL.launches == n0 + 1
    assert torch.equal(paged[row], alone[0])


@pytest.mark.parametrize("dh,g", [(128, 4), (80, 4), (256, 2), (128, 6)])
def test_decode_early_exit_is_an_exact_no_op(dev, dh, g):
    """A row whose keys end at position 100 gives the same bits in a
    112-position cache and in a 1,024-position one whose later positions
    are masked, whether as empty slots (position -1, K and V NaN: never
    read, no split or tile of them takes part) or as future positions
    (past the row's position, with finite K and V)."""
    r = np.random.default_rng(dh + g)
    b, hkv, n = 3, 2, 100
    h = g * hkv
    q = _bf16(r, (b, h, dh), dev)
    k1, v1 = (_bf16(r, (b, hkv, dh), dev) for _ in range(2))
    ck, cv = (_bf16(r, (b, 1024, hkv, dh), dev) for _ in range(2))
    pos = torch.full((b,), n, dtype=torch.int32, device=dev)
    short = ops.decode_attention(q, ck[:, :112].contiguous(),
                                 cv[:, :112].contiguous(),
                                 _causal(112, pos, dev), k1, v1, pos)
    ar = torch.arange(1024, device=dev, dtype=torch.int32)[None].repeat(b, 1)
    future = ops.decode_attention(q, ck, cv, torch.where(ar < n, ar, ar + 1),
                                  k1, v1, pos)
    ckn, cvn = ck.clone(), cv.clone()
    ckn[:, n:] = float("nan")
    cvn[:, n:] = float("nan")
    empty = ops.decode_attention(q, ckn, cvn, _causal(1024, pos, dev), k1,
                                 v1, pos)
    assert torch.equal(future, short) and torch.equal(empty, short)


@pytest.mark.parametrize("name,kind,shape",
                         [t for t in bits.TIMED if t[1] in ("decode",
                                                            "paged")],
                         ids=lambda x: x if isinstance(x, str) else "")
def test_decode_bf16_rounds_once_at_the_served_shapes(dev, name, kind,
                                                      shape):
    """bf16 fused and paged decode at the serving paths' shapes, within
    half a bf16 ulp + 1e-4 of the float32 plain version on the same
    inputs: float32 inside, one rounding at the output."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*sh):
        return torch.randn(sh, generator=g, device="cuda").bfloat16()
    args = bits.decode_inputs(kind, shape, randn, g)
    kw = dict(softcap=shape.get("softcap", 0.0))
    if kind == "decode":
        kw["window"] = shape.get("window", 0)
        got = ops.decode_attention(*args, **kw)
        want = da.decode_attention_plain(*(
            t.float() if t.is_floating_point() else t for t in args), **kw)
    else:
        got = ops.decode_attention_paged(*args, **kw)
        want = da.decode_attention_paged_plain(*(
            t.float() if t.is_floating_point() else t for t in args), **kw)
    assert bool(((got.float() - want).abs() <=
                 1e-4 + 2.0 ** -8 * want.abs()).all())


def test_decode_split_scratch_is_sized_by_the_shapes(dev):
    """The split body's scratch, as decode_attention_workspace sizes it:
    per split of each (row, kv-head) G * Dh acc and 2 * G (m, l) floats,
    then B * Hkv int32 ticket counters. The positions per split, read off
    where a 1-head call's scratch grows, are one of the split sizes at
    which test_torch_kernels.py holds the plain split arithmetic to the
    fused reference (16, 64, 128, 256)."""
    def words(sc, b=1):
        return kbuild.size("decode_attention", "decode_attention_workspace",
                           b, 1, 1, 32, sc, 1)
    split = next(sc for sc in range(1, 1025) if words(sc + 1) > words(sc))
    assert split in (16, 64, 128, 256)
    assert words(1) == words(split) == 34 + 1
    assert words(split + 1) == 2 * 34 + 1
    assert words(1, b=3) == 3 * (34 + 1)


@pytest.mark.parametrize("kind", ["decode", "paged"])
def test_decode_split_calls_own_their_counters(dev, kind):
    """Each bf16 call carries its own ticket counters, zeroed on its stream:
    calls on two streams at once, and calls replayed from a CUDA graph,
    give the bits of the same calls made one after another; a scratch
    buffer left full of other values changes nothing."""
    shape = dict(b=4, h=8, hkv=2, dh=128, sc=1024, nblk=64, lo=96)
    g = torch.Generator(device="cuda").manual_seed(3)

    def randn(*sh):
        return torch.randn(sh, generator=g, device="cuda").bfloat16()
    cases = [bits.decode_inputs(kind, shape, randn, g) for _ in range(2)]
    fn = ops.decode_attention if kind == "decode" else \
        ops.decode_attention_paged
    want = [fn(*args) for args in cases]
    junk = torch.full((1 << 24,), -7, dtype=torch.int32, device="cuda")
    del junk                              # the cached blocks hold -7s
    streams = [torch.cuda.Stream() for _ in cases]
    torch.cuda.synchronize()
    got = [None, None]
    for _ in range(20):
        for i, (st, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(st):
                got[i] = fn(*args)
        torch.cuda.synchronize()
        for w, o in zip(want, got):
            assert torch.equal(w, o)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*args) for args in cases]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for w, o in zip(want, outs):
            assert torch.equal(w, o)


# --------------------------------------------------------------------------
# the bf16 partial kernel on the split body
# --------------------------------------------------------------------------

def _partial_case(r, dh, g, sc, lens, dev):
    """bf16 q and a [8, sc] cache of 2 kv-heads; row i holds positions
    0 .. lens[i] - 1 (-1: no valid key)."""
    h = 2 * g
    q = _bf16(r, (len(lens), h, dh), dev)
    ck, cv = (_bf16(r, (len(lens), sc, 2, dh), dev) for _ in range(2))
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, ck, cv, _causal(sc, pos, dev), pos


@pytest.mark.parametrize("dh,g", bits.PARTIAL_PAIRS)
def test_partial_kernel_on_the_split_body(dev, dh, g):
    """Sc 4,608 (36 splits, past the merge's chunk of 32), 8 rows of
    random lengths and one without a valid key, a softcap: one launch a
    call; m and l at 2e-5 of the plain partials and acc as acc / l; the
    row without a key gives m = -1e30, l = 0, acc = 0 exactly; the
    partials combined with (k1, v1) give the fused kernel's output; the
    scratch is the fused kernel's at the same shapes."""
    r = np.random.default_rng(dh * 7 + g)
    sc = 4608
    lens = [int(x) for x in r.integers(1, sc, size=8)]
    lens[3] = -1
    q, ck, cv, cpos, pos = _partial_case(r, dh, g, sc, lens, dev)
    k1, v1 = (_bf16(r, (8, 2, dh), dev) for _ in range(2))
    kw = dict(softcap=50.0)
    n = da.PARTIAL_KERNEL.launches
    m, l, acc = ops.decode_attention_partial(q, ck, cv, cpos, pos, **kw)
    assert da.PARTIAL_KERNEL.launches == n + 1
    wm, wl, wacc = da.decode_attention_partial_plain(q, ck, cv, cpos, pos,
                                                     **kw)
    keys = pos >= 0
    for got, want in ((m, wm), (l, wl), (acc[keys] / l[keys][..., None],
                                         wacc[keys] / wl[keys][..., None])):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert bool((m[3] == -1e30).all()) and not l[3].any() and \
        not acc[3].any()
    _close(da.combine_decode_partials(q, m, l, acc, k1, v1, softcap=50.0),
           ops.decode_attention(q, ck, cv, cpos, k1, v1, pos, **kw),
           torch.bfloat16)
    args = (8, 2 * g, 2, dh, sc, 1)
    assert kbuild.size("decode_attention",
                       "decode_attention_partial_workspace", *args) == \
        kbuild.size("decode_attention", "decode_attention_workspace", *args)


@pytest.mark.parametrize("dh,g", bits.PARTIAL_PAIRS)
def test_partial_row_bits_do_not_depend_on_the_call(dev, dh, g):
    """A row's bf16 partials have the same bits alone (B 1), inside a
    batch of 8 rows of other lengths, and in a cache with a larger Sc
    whose extra positions are masked (an all-masked tail of splits), with
    a window."""
    r = np.random.default_rng(dh + g * 11)
    sc, row, n = 600, 5, 530
    lens = [int(x) for x in r.integers(1, sc, size=8)]
    lens[row] = n
    q, ck, cv, cpos, pos = _partial_case(r, dh, g, sc, lens, dev)
    kw = dict(window=400, softcap=30.0)
    alone = ops.decode_attention_partial(
        q[row:row + 1], ck[row:row + 1], cv[row:row + 1], cpos[row:row + 1],
        pos[row:row + 1], **kw)
    batch = ops.decode_attention_partial(q, ck, cv, cpos, pos, **kw)
    big = 1500
    ckb, cvb = (torch.cat([c, _bf16(r, (8, big - sc, 2, dh), dev)], 1)
                for c in (ck, cv))
    wide = ops.decode_attention_partial(q, ckb, cvb, _causal(big, pos, dev),
                                        pos, **kw)
    for one, b8, bw in zip(alone, batch, wide):
        assert torch.equal(b8[row], one[0]) and torch.equal(bw[row], one[0])


@pytest.mark.parametrize("dh,g", bits.PARTIAL_PAIRS)
def test_partial_calls_own_their_counters(dev, dh, g):
    """bf16 partial calls on two streams at once, and replayed from a
    CUDA graph, give the bits of the same calls made one after another."""
    r = np.random.default_rng(dh * 3 + g)
    cases = [_partial_case(r, dh, g, 1024,
                           [int(x) for x in r.integers(96, 1024, size=8)],
                           dev) for _ in range(2)]
    want = [ops.decode_attention_partial(*args) for args in cases]
    streams = [torch.cuda.Stream() for _ in cases]
    torch.cuda.synchronize()
    got = [None, None]
    for _ in range(5):
        for i, (st, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(st):
                got[i] = ops.decode_attention_partial(*args)
        torch.cuda.synchronize()
        for w, o in zip(want, got):
            assert all(torch.equal(a, b) for a, b in zip(w, o))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ops.decode_attention_partial(*args) for args in cases]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for w, o in zip(want, outs):
            assert all(torch.equal(a, b) for a, b in zip(w, o))


# --------------------------------------------------------------------------
# the decode and flash kernels keep their earlier bits
# --------------------------------------------------------------------------

# sha256 (first 16 hex digits) of each kernel's output on the seeded inputs
# of repro_torch.kernels.bits, at every (Dh, G) the decode kernels and every
# head dim the flash kernel were built for before Dh 80 and 256 and G 6
# came in. Taken on an NVIDIA H100 80GB HBM3 from the kernels built from
# the sources before that change (``python -m repro_torch.kernels.bits
# --csrc DIR``, which found them equal to the changed sources' in all 80
# cases). The 40 float32 digests (decode and flash) keep those values. The
# 8 bfloat16 flash digests are those of the tensor-core body that replaced
# the CUDA-core one for bfloat16 (per-tile softmax, P as hi + lo bf16
# operands of wgmma); the 32 bfloat16 decode digests are those of the split
# body that replaced the warp body for bfloat16 (per-tile and per-split
# sums of 128-position splits): 7 of them changed, the other 25 rounded to
# the same bf16 outputs. The 8 partial digests (Sc 300, three splits, a row
# without a valid key) are those of the kernels built for it: the float32
# ones of the warp body (at (80, 4), (128, 6) and (256, 2) equal to the
# kernel before the bfloat16 partials moved to the split body; (128, 4) was
# built with that move), the bfloat16 ones of the split body.
EARLIER_BITS = {
    ('fused', 32, 1, 'float32'): "20b95c6b5188d0b7",
    ('fused', 32, 1, 'bfloat16'): "8afa7aec806a2cf1",
    ('fused', 32, 2, 'float32'): "a83b703f676f0223",
    ('fused', 32, 2, 'bfloat16'): "2380b83492732288",
    ('fused', 32, 4, 'float32'): "8a361f15bcc4a76a",
    ('fused', 32, 4, 'bfloat16'): "6b9dd65c1b48c0a6",
    ('fused', 32, 8, 'float32'): "0ac54b10b12ec0cc",
    ('fused', 32, 8, 'bfloat16'): "07c0103d3d2e17ff",
    ('fused', 64, 1, 'float32'): "5c7fcae5da9e92a1",
    ('fused', 64, 1, 'bfloat16'): "3f563fe18b210594",
    ('fused', 64, 2, 'float32'): "a1d2902aa7e90d32",
    ('fused', 64, 2, 'bfloat16'): "01f065beb9744231",
    ('fused', 64, 4, 'float32'): "227a2ac26e4f0055",
    ('fused', 64, 4, 'bfloat16'): "1ba3cf78e3892f74",
    ('fused', 64, 8, 'float32'): "c7e68b7e3ff0e619",
    ('fused', 64, 8, 'bfloat16'): "9a3d974288f31c9a",
    ('fused', 112, 1, 'float32'): "19924d74089b7fbe",
    ('fused', 112, 1, 'bfloat16'): "6b92bc3d5f1dc9cb",
    ('fused', 112, 2, 'float32'): "a5e00deaa4fdf775",
    ('fused', 112, 2, 'bfloat16'): "34e48d83b4dbff26",
    ('fused', 112, 4, 'float32'): "6c407aaf74b52724",
    ('fused', 112, 4, 'bfloat16'): "535f87a642185f30",
    ('fused', 112, 8, 'float32'): "880f0324ceac5f8c",
    ('fused', 112, 8, 'bfloat16'): "88c82bc6a4107082",
    ('fused', 128, 1, 'float32'): "463ce069e2e4d82d",
    ('fused', 128, 1, 'bfloat16'): "0adca9a4992cc4ec",
    ('fused', 128, 2, 'float32'): "ead1fb67621f5992",
    ('fused', 128, 2, 'bfloat16'): "43bfa52163168443",
    ('fused', 128, 4, 'float32'): "b6d2caf3e1ffa976",
    ('fused', 128, 4, 'bfloat16'): "a0070fe647cb1c5e",
    ('fused', 128, 8, 'float32'): "79813f78bd6a610a",
    ('fused', 128, 8, 'bfloat16'): "a8a8a4a8f24b67f2",
    ('paged', 32, 1, 'float32'): "7479788e54e58a26",
    ('paged', 32, 1, 'bfloat16'): "7f11586c2ff24e10",
    ('paged', 32, 2, 'float32'): "7de099e2a3537a88",
    ('paged', 32, 2, 'bfloat16'): "5bd8593af822b9b7",
    ('paged', 32, 4, 'float32'): "9c0d30f2576fa002",
    ('paged', 32, 4, 'bfloat16'): "f8b58aef274bd335",
    ('paged', 32, 8, 'float32'): "708b17d4718250a4",
    ('paged', 32, 8, 'bfloat16'): "7a7e9153f14bd3e6",
    ('paged', 64, 1, 'float32'): "9e419c52c3966137",
    ('paged', 64, 1, 'bfloat16'): "2fceb1e9ef5f5ce6",
    ('paged', 64, 2, 'float32'): "00e2def337a93830",
    ('paged', 64, 2, 'bfloat16'): "f88e00c8dd0140b9",
    ('paged', 64, 4, 'float32'): "94745f8286bf3be9",
    ('paged', 64, 4, 'bfloat16'): "c783903abad5e007",
    ('paged', 64, 8, 'float32'): "b2a1b04a6b5f72a8",
    ('paged', 64, 8, 'bfloat16'): "e716b7deb289012d",
    ('paged', 112, 1, 'float32'): "02bd33b4132e54a0",
    ('paged', 112, 1, 'bfloat16'): "a4a1374a41afe717",
    ('paged', 112, 2, 'float32'): "f133ea5409908cef",
    ('paged', 112, 2, 'bfloat16'): "41759851290c9027",
    ('paged', 112, 4, 'float32'): "30993a7033e313f1",
    ('paged', 112, 4, 'bfloat16'): "6deef564a8c08ccf",
    ('paged', 112, 8, 'float32'): "b3e1da9c1cb6fe89",
    ('paged', 112, 8, 'bfloat16'): "8e469dd13152248b",
    ('paged', 128, 1, 'float32'): "9e01e5fec9be958a",
    ('paged', 128, 1, 'bfloat16'): "9ad3007df81d0917",
    ('paged', 128, 2, 'float32'): "c356bb18714d2f04",
    ('paged', 128, 2, 'bfloat16'): "fd9d8602c2c1bc26",
    ('paged', 128, 4, 'float32'): "cd5dfbade7a011b7",
    ('paged', 128, 4, 'bfloat16'): "95563fc85c69c500",
    ('paged', 128, 8, 'float32'): "d17ef2e6127d53a1",
    ('paged', 128, 8, 'bfloat16'): "439fa3b3d9dbaedf",
    ('flash', 32, 1, 'float32'): "a2894d79f3663eb5",
    ('flash', 32, 1, 'bfloat16'): "0f1e6a8e02f3b7d5",
    ('flash', 32, 4, 'float32'): "b453b54c2f1d21c2",
    ('flash', 32, 4, 'bfloat16'): "aeb542d226068b10",
    ('flash', 64, 1, 'float32'): "efa46a09c1859931",
    ('flash', 64, 1, 'bfloat16'): "28203f67ea0fe61f",
    ('flash', 64, 4, 'float32'): "aad47be4bdfa430c",
    ('flash', 64, 4, 'bfloat16'): "9d8f1cbcf4653998",
    ('flash', 112, 1, 'float32'): "08d687b4377ce018",
    ('flash', 112, 1, 'bfloat16'): "bf15f21b3054c59b",
    ('flash', 112, 4, 'float32'): "91c4e8989eeb1cd7",
    ('flash', 112, 4, 'bfloat16'): "3c1b012358ce6e2b",
    ('flash', 128, 1, 'float32'): "e28f7bce12fcaf57",
    ('flash', 128, 1, 'bfloat16'): "8d2e75c618824844",
    ('flash', 128, 4, 'float32'): "0436e3108e2cdae2",
    ('flash', 128, 4, 'bfloat16'): "b39f47405d1cf23d",
    ('partial', 80, 4, 'float32'): "22acd18708577eae",
    ('partial', 80, 4, 'bfloat16'): "7236912e4b6d5a3e",
    ('partial', 128, 4, 'float32'): "423319dc26c2004a",
    ('partial', 128, 4, 'bfloat16'): "08f73f25ab30fda3",
    ('partial', 128, 6, 'float32'): "2f8594aef660c4d2",
    ('partial', 128, 6, 'bfloat16'): "9d90a1ddaa8a70e5",
    ('partial', 256, 2, 'float32'): "cb7179909af7d540",
    ('partial', 256, 2, 'bfloat16'): "aa58d1850934fe32",
}


@pytest.mark.parametrize("case", bits.CASES, ids=str)
def test_attention_kernels_keep_their_earlier_bits(dev, case):
    assert bits.digest(bits.run_port(case)) == EARLIER_BITS[case]


# --------------------------------------------------------------------------
# step graphs: the decode plane's CUDA graphs against the eager step
# --------------------------------------------------------------------------

SEG_SPECS = [(np.arange(1, 9, dtype=np.int32), 5),
             (np.arange(2, 12, dtype=np.int32), 11),
             (np.arange(5, 12, dtype=np.int32), 16)]


def _graph_engine(seg_len=1, **kw):
    """A reduced float32 Mixtral engine on the card (capacity factor 4,
    max_batch 4, max_seq 64, engine options ``kw``) with the three
    requests of SEG_SPECS submitted."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving.api import RequestSpec
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = get_config("mixtral_8x7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    eng = InferenceEngine(cfg, EngineConfig(
        max_batch=4, max_seq=64, num_aw=2, num_ew=2,
        decode_segment_len=seg_len, **kw), seed=7, device="cuda")
    handles = [eng.client.submit(RequestSpec(rid=f"s{i}", prompt=p,
                                             max_new=n))
               for i, (p, n) in enumerate(SEG_SPECS)]
    return eng, handles


def _leaves(cache):
    return [t for layer in cache["layers"] for t in layer.values()]


def _replay_equals_eager(eng, seg_len):
    """A replay of the seg_len step graph gives the ring, the slot loads
    and every cache tensor (state leaves included) of the eager step from
    the same state, the eager step reading the engine's RouteState (the
    graph reads the plane's copy)."""
    plane = eng.decode_plane
    key = plane.load(eng.active_requests(), seg_len)
    before = [t.clone() for t in _all_leaves(eng.cache)]
    ring, loads = (t.clone() for t in plane.segment(key[0], key[1],
                                                    eng.route_state))
    eager = [t.clone() for t in _all_leaves(eng.cache)]
    for t, b in zip(_all_leaves(eng.cache), before):
        t.copy_(b)
    if plane.graphs.get(key) is None:
        plane.graphs[key] = plane.capture(key)
    g_ring, g_loads = plane.graphs[key].replay()
    assert torch.equal(g_ring, ring) and torch.equal(g_loads, loads)
    assert all(torch.equal(a, b) for a, b in zip(_all_leaves(eng.cache), eager))
    for t, b in zip(_all_leaves(eng.cache), before):
        t.copy_(b)
    return loads


@pytest.mark.parametrize("seg_len", [1, 8])
def test_step_graph_replay_equals_the_eager_step(dev, seg_len):
    eng, _ = _graph_engine()
    eng.step()
    eng.step()
    loads = _replay_equals_eager(eng, seg_len)
    assert loads.shape == (seg_len, eng.api.placement.num_slots)
    assert loads.sum() > 0


def test_step_graph_routes_by_the_new_route_state(dev):
    """After fail_ew and after re-pointed shadows, a replay routes by the
    engine's RouteState: no load on the dead EW's slots."""
    eng, handles = _graph_engine()
    eng.step()
    owner = eng.route_state.slot_owner.cpu()
    eng.fail_ew(0)
    for seg in (1, 8):
        loads = _replay_equals_eager(eng, seg)
        assert loads[:, owner == 0].sum() == 0 and loads.sum() > 0
    eng.provision_ew(0, repoint_protect=1)
    eng.fail_ew(1)
    for seg in (1, 8):
        loads = _replay_equals_eager(eng, seg)
        assert loads[:, owner == 1].sum() == 0 and loads.sum() > 0
    while not all(h.done() for h in handles):
        eng.step()


def test_plan_installs_replay_the_step_graphs(dev):
    """Placement generations are RouteState copies into the graphs' own
    tensors: after a scale-out, a rebalance with split replicas and a
    shadow promotion, each replay (seg 1 and 8) equals the eager step, no
    graph is captured anew, the drained loads are the eager step's
    ``slot_load`` (one host sync a step), and the streams are those of an
    engine that never changed its plan."""
    eng, handles = _graph_engine(max_ew=3)
    for _ in range(2):
        eng.step()
    for seg in (1, 8):
        _replay_equals_eager(eng, seg)
    base = eng.decode_plane.captures()
    mgr = eng.placement_mgr

    def check(what):
        for seg in (1, 8):
            _replay_equals_eager(eng, seg)
        loads = _replay_equals_eager(eng, 1)
        n = mgr.load.total_recorded
        eng.step()                        # the seg-1 graph's replay
        assert np.array_equal(eng.decode_plane.host_loads,
                              loads.cpu().numpy()), what
        assert mgr.load.total_recorded == n + float(loads.sum()), what
        assert eng.decode_plane.captures() == base, what
    eng.add_ew(now=1.0)
    check("scale-out")
    plan = eng.rebalance(now=2.0)
    if (plan.split_slot < 0).all():
        # the loads of two steps gave no split: replicate expert 0 into an
        # empty slot of another EW and split its traffic there
        owner, se = plan.slot_owner, plan.slot_expert.copy()
        s = int(np.nonzero((se < 0) & (owner >= 0) &
                           (owner != owner[plan.primary[0]]))[0][0])
        se[s] = 0
        split = plan.split_slot.copy()
        split[0] = s
        eng.install_plan(mgr.adopt(se, split_slot=split, reason="split"),
                         now=2.0)
    assert (eng.route_state.split_slot >= 0).any()
    check("rebalance with split slots")
    # the replicas serve the same weights: so far the plan-free streams
    head = [h.tokens() for h in handles]
    eng.fail_ew(0)
    eng.promote_shadows(0, now=3.0)
    check("promotion")
    assert eng.gateway.stats.host_syncs == eng.steps
    while not all(h.done() for h in handles):
        eng.step()
    want, plain = _graph_engine()
    while not all(h.done() for h in plain):
        want.step()
    assert head == [h.tokens()[:len(t)] for h, t in zip(plain, head)]
    assert sum(len(t) for t in head) > 3


def test_segments_capture_nothing_new_after_warm_up(dev):
    """seg 8 on the card gives seg 1's streams; after the first segment,
    tails, finished rows, sampling changes and failures replay the one
    graph, and launches count on every replay."""
    from repro_torch.serving.api import RequestSpec, SamplingParams
    streams = {}
    for seg in (1, 8):
        eng, handles = _graph_engine(seg)
        eng.step()
        base = eng.decode_plane.captures()
        assert base == 1
        n0 = da.KERNEL.launches
        eng.step()
        # one fused decode launch per layer and step, on the replay
        assert da.KERNEL.launches - n0 == eng.cfg.num_layers * seg
        while not all(h.done() for h in handles):
            eng.step()
        streams[seg] = [h.tokens() for h in handles]
        for h in handles:
            eng.release_request(h.rid)
        h = eng.client.submit(RequestSpec(
            rid="x", prompt=np.arange(3, 9, dtype=np.int32), max_new=12,
            sampling=SamplingParams(greedy=False, temperature=0.7,
                                    top_k=5)))
        eng.step()
        eng.fail_aw(eng.requests["x"].aw)
        eng.recover_aw_requests()
        eng.fail_ew(0)
        while not h.done():
            eng.step()
        assert eng.decode_plane.captures() == base
    assert streams[8] == streams[1]


# --------------------------------------------------------------------------
# the prefix-cache and telemetry planes on the card
# --------------------------------------------------------------------------

def _prefix_engine(**kw):
    """A reduced float32 Mixtral engine on the card (capacity factor 4,
    max_batch 4, max_seq 64, chunk budget 8, session affinity) with the
    prefix cache on (``prefix_cache_slots`` 2) unless ``kw`` says
    otherwise."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = get_config("mixtral_8x7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    opts = dict(max_batch=4, max_seq=64, num_aw=2, num_ew=2,
                chunk_token_budget=8, placement="session_affinity",
                prefix_cache_slots=2)
    opts.update(kw)
    return InferenceEngine(cfg, EngineConfig(**opts), seed=7, device="cuda")


def _all_leaves(cache):
    """Every tensor of a cache, the paged block table included."""
    return _leaves(cache) + [t for k, t in cache.items() if k != "layers"]


def _run_turns(eng, turns, max_new=4):
    """Submit each (rid, prompt, session) of ``turns`` together, step to
    the end releasing finished requests; the streams by rid."""
    from repro_torch.serving.api import RequestSpec
    hs = [eng.client.submit(RequestSpec(rid=rid, prompt=p, max_new=max_new,
                                        session=s)) for rid, p, s in turns]
    while not all(h.done() for h in hs):
        eng.step()
        for rid in [r.rid for r in eng.requests.values() if r.done]:
            eng.release_request(rid)
    return {h.rid: h.tokens() for h in hs}


PREFIX_P1 = np.arange(1, 27, dtype=np.int32)
PREFIX_TURNS = [[("a", PREFIX_P1, "s")],
                [("b", np.concatenate([PREFIX_P1, np.arange(40, 47)]), "s"),
                 ("c", np.concatenate([PREFIX_P1, np.arange(60, 69)]),
                  "t")]]


@pytest.mark.parametrize("paged", [False, True])
def test_prefix_adoption_writes_the_cache_in_place(dev, paged):
    """``copy_page``, ``scrub_slot`` and the adoptions of a warm turn write
    into the cache's own tensors (every leaf's ``data_ptr`` unchanged), so
    the step graphs that captured them read the adopter's KV; the warm
    streams equal a cache-off engine's."""
    kw = {"kv_page_tokens": 16} if paged else {}
    eng = _prefix_engine(**kw)
    ptrs = [t.data_ptr() for t in _all_leaves(eng.cache)]
    got = {}
    for turn in PREFIX_TURNS:
        got.update(_run_turns(eng, turn))
    assert eng.gateway.stats.prefix_hits >= 1
    cold = _prefix_engine(prefix_cache_slots=0, **kw)
    want = {}
    for turn in PREFIX_TURNS:
        want.update(_run_turns(cold, turn))
    assert got == want
    eng.layout.scrub_slot(eng.cache, 0, 5)
    if paged:
        eng.layout.copy_page(eng.cache, 1, 2)
        assert all(torch.equal(t[1], t[2]) for t in _leaves(eng.cache))
        eng.pages.check()
    else:
        assert (eng.cache["layers"][0]["pos"][0] < 5).all()
    assert [t.data_ptr() for t in _all_leaves(eng.cache)] == ptrs


def test_paged_graph_replay_after_adoption_equals_eager(dev):
    """Two requests adopt one cached entry's pages (shared pages mapped in
    two decoding rows, a private boundary copy each): a replay of the
    paged step graph equals the eager step from the same state, and the
    streams equal a contiguous cache-off engine's."""
    from repro_torch.serving.api import RequestSpec
    eng = _prefix_engine(kv_page_tokens=16, prefix_global_index=True)
    _run_turns(eng, PREFIX_TURNS[0])
    base = eng.decode_plane.captures()
    hs = [eng.client.submit(RequestSpec(rid=rid, prompt=p, max_new=6,
                                        session=s))
          for rid, p, s in PREFIX_TURNS[1]]
    while eng.prefilling_requests() or len(eng.active_requests()) < 2:
        eng.step()
    assert all(eng.requests[h.rid].prefix_hit > 0 for h in hs)
    rows = [set(eng.pages.slot_pages(r.slot)) for r in eng.active_requests()]
    assert any(eng.pages.ref[p] > 1 for p in rows[0] & rows[1])
    _replay_equals_eager(eng, 1)
    while not all(h.done() for h in hs):
        eng.step()
    assert eng.decode_plane.captures() == base
    got = {h.rid: h.tokens() for h in hs}
    cold = _prefix_engine(prefix_cache_slots=0)
    _run_turns(cold, PREFIX_TURNS[0])
    assert got == _run_turns(cold, PREFIX_TURNS[1], max_new=6)


def test_telemetry_adds_no_capture_and_no_host_sync(dev):
    """``run_serving`` over a chat workload, where every hook fires: with
    telemetry on, no hook makes a synchronizing CUDA call (counted by
    ``torch.cuda.set_sync_debug_mode``) while the serving path makes its
    own (the token drains); telemetry on and off give the same streams,
    the same step-graph keys and the same host-sync count."""
    import warnings

    from repro_torch.data.workloads import make_workload
    from repro_torch.serving.scheduler import run_serving

    def syncs(caught):
        return sum("synchroniz" in str(w.message) for w in caught)
    out = {}
    for tel in (True, False):
        eng = _prefix_engine(telemetry=tel)
        wl = make_workload("multi_turn_chat", 8.0, 1.0, seed=0,
                           max_prompt=16, max_new=8)
        in_hooks = []
        if tel:
            plane = eng.telemetry
            for name in dir(plane):
                if not name.startswith(("on_", "observe_")):
                    continue

                def hooked(*a, _fn=getattr(plane, name), **kw):
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        try:
                            return _fn(*a, **kw)
                        finally:
                            in_hooks.extend(caught)
                setattr(plane, name, hooked)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                m = run_serving(eng, wl, 60.0, step_time=0.05)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert syncs(caught) >= eng.steps > 0
        assert syncs(in_hooks) == 0
        out[tel] = (m.outputs, sorted(eng.decode_plane.graphs),
                    eng.gateway.stats.host_syncs)
        if tel:
            assert m.telemetry.registry.hist("tbt").count > 0
    assert out[True] == out[False]


def test_capture_survives_a_dead_engine_collected_mid_capture(dev):
    """An engine holds reference cycles, so a dropped one (with its step
    graphs) is freed by the garbage collector, whenever that runs. A
    graph's reset while another graph captures voids the capture: here
    the collector is made to run inside the capture (a low threshold and
    allocations while the stream captures), with a dropped engine still
    uncollected; the new engine captures its step graph all the same and
    gives the dropped engine's streams."""
    import gc
    old, handles = _graph_engine()
    while not all(h.done() for h in handles):
        old.step()
    want = [h.tokens() for h in handles]
    assert old.decode_plane.captures() == 1
    threshold = gc.get_threshold()
    gc.disable()
    del old, handles                 # garbage, not collected yet
    try:
        eng, handles = _graph_engine()
        plane = eng.decode_plane
        segment = plane.segment

        def collecting(*args, **kw):
            if torch.cuda.is_current_stream_capturing():
                gc.set_threshold(1, 1, 1)
                _ = [[] for _ in range(2000)]   # collections, if enabled
            return segment(*args, **kw)
        plane.segment = collecting
        gc.set_threshold(1 << 30)
        gc.enable()
        while not all(h.done() for h in handles):
            eng.step()
    finally:
        gc.set_threshold(*threshold)
        gc.enable()
    assert eng.decode_plane.captures() == 1
    assert [h.tokens() for h in handles] == want


def _incident_engine(**kw):
    """A reduced float32 Mixtral engine on the card (capacity factor 4,
    max_batch 8, max_seq 96, chunk budget 16, paged KV) for the reference
    incident's shape (tests/test_flightrec.py), seeded weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = get_config("mixtral_8x7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    opts = dict(max_batch=8, max_seq=96, num_aw=2, num_ew=2,
                chunk_token_budget=16, prefill_token_cap=128,
                kv_page_tokens=16)
    opts.update(kw)
    return InferenceEngine(cfg, EngineConfig(**opts), seed=7, device="cuda")


def _incident(eng):
    """mixed_slo at 3 rps for 2 s, AW0 failed at 0.4 s, on the virtual
    clock of 20 ms a step and 2 ms a prefill token."""
    from repro_torch.core.costmodel import TarragonProfile
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.data.workloads import make_workload
    from repro_torch.serving.scheduler import FailurePlan, run_serving
    wl = make_workload("mixed_slo", rate_rps=3.0, duration=2.0, seed=7,
                       max_new=40, interactive_deadline=0.3, batch_wave=8,
                       batch_every=3.0)
    orch = Orchestrator(eng, profile=TarragonProfile(detect=0.05,
                                                     detect_retries=2),
                        worker_init_time=0.5)
    return run_serving(eng, wl, 60.0, orchestrator=orch,
                       failures=[FailurePlan(0.4, "aw", 0)],
                       step_time=0.02, prefill_token_time=0.002)


def test_control_and_forensics_hooks_make_no_host_sync(dev):
    """The controller (every policy, controller-chosen victims), the
    flight recorder and the watchdogs on, through the reference incident:
    no hook of either plane makes a synchronizing CUDA call (counted by
    ``torch.cuda.set_sync_debug_mode``) while the serving path makes its
    own; recorder and watchdogs on and off give the same streams, step
    graph keys and host-sync count, one sync a decode step."""
    import warnings

    def syncs(caught):
        return sum("synchroniz" in str(w.message) for w in caught)
    out = {}
    for on in (True, False):
        eng = _incident_engine(controller="on", victim_policy="controller",
                               max_ew=3, flight_recorder=on, watchdogs=on)
        in_hooks = []

        def hook(obj, names):
            for name in names:
                def hooked(*a, _fn=getattr(obj, name), **kw):
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        try:
                            return _fn(*a, **kw)
                        finally:
                            in_hooks.extend(caught)
                setattr(obj, name, hooked)
        hook(eng.controller, ("tick", "choose_victim", "stats"))
        if on:
            fr = eng.flightrec
            hook(fr, [n for n in dir(fr) if n.startswith(("on_", "note_"))]
                 + ["tick", "fingerprint", "dump"])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                m = _incident(eng)
                if on:
                    bundle = eng.flightrec.dump(reason="sync test")
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert syncs(caught) >= eng.steps > 0
        assert syncs(in_hooks) == 0
        assert eng.gateway.stats.host_syncs == eng.steps
        eng.pages.check()
        out[on] = (m.outputs, sorted(eng.decode_plane.graphs),
                   eng.gateway.stats.host_syncs)
        if on:
            counts = eng.controller.counts
            assert counts["budget"] >= 1 and counts["preempt"] >= 1, counts
            assert eng.flightrec.watchdogs.trips == []
            assert bundle["outputs"] == m.outputs
    assert out[True] == out[False]


def test_exact_replay_on_the_card_is_bit_identical(dev, tmp_path):
    """A seed-built engine's bundle names its seed; the replay rebuilds
    the weights on the card and gives every recorded stream bit for bit
    (``python -m repro_torch.launch.replay`` does the same)."""
    from repro_torch.launch.replay import load_bundle, replay_bundle
    eng = _incident_engine(controller="on", victim_policy="controller",
                           max_ew=3)
    m = _incident(eng)
    path = str(tmp_path / "incident.postmortem.json")
    eng.flightrec.dump(path, reason="card replay")
    bundle = load_bundle(path)
    assert bundle["config"]["weights"] == {"seed": 7}
    report = replay_bundle(bundle, device="cuda")
    assert report["ok"] and report["config_hash_ok"], report
    assert report["matched"] == len(m.outputs) > 0


# --------------------------------------------------------------------------
# the recurrent and encoder-decoder families: Whisper's attention shapes,
# and each family's decode step graph
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h", [(2, 40, 6), (1, 1500, 12)])
def test_flash_attention_without_causal_mask(dev, dtype, b, s, h):
    """An encoder's full attention (Dh 64, G 1): the small case and the
    Whisper encoder's 1,500 frames, against the plain version with no
    causal mask."""
    r = np.random.default_rng(s)
    q, k, v = (_randn(r, (b, s, h, 64), dtype, dev) for _ in range(3))
    p = torch.arange(s, device=dev, dtype=torch.int32).repeat(b, 1)
    n = fa.KERNEL.launches
    got = ops.full_attention(q, k, v, p, p, causal=False)
    assert fa.KERNEL.launches == n + 1
    want = blockwise_attention(q, k, v, p, p, causal=False, block_q=s,
                               block_k=16)
    _close(got, want, dtype)
    # the causal call differs: the mask is not applied by default
    assert not torch.equal(got, ops.full_attention(q, k, v, p, p))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sc", [40, 256])
def test_decode_attention_at_dh64_g1(dev, dtype, sc):
    """Whisper's decoder self-attention: H = Hkv 12, Dh 64, 8 rows."""
    r = np.random.default_rng(sc)
    b, h, dh = 8, 12, 64
    q = _randn(r, (b, h, dh), dtype, dev)
    ck, cv = (_randn(r, (b, sc, h, dh), dtype, dev) for _ in range(2))
    k1, v1 = (_randn(r, (b, h, dh), dtype, dev) for _ in range(2))
    pos = torch.tensor(r.integers(1, sc, size=(b,)), dtype=torch.int32,
                       device=dev)
    ar = torch.arange(sc, device=dev, dtype=torch.int32)[None]
    cpos = torch.where(ar < pos[:, None], ar, torch.full_like(ar, -1))
    args = (q, ck, cv, cpos, k1, v1, pos)
    n = da.KERNEL.launches
    _close(ops.decode_attention(*args), da.decode_attention_plain(*args),
           dtype)
    assert da.KERNEL.launches == n + 1


@pytest.mark.parametrize("arch", ["xlstm_350m", "whisper_small"])
def test_family_step_graph_replay_equals_the_eager_step(dev, arch):
    """A reduced bf16 xLSTM (a cache of state leaves only, a RouteState
    with zero slots) and Whisper (self attention, a plain cross attention
    over the encoder's frames): the seg-1 step graph's replay gives the
    token ring and every cache tensor of the eager step from the same
    state, and the engine captures no graph after its first step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving.api import RequestSpec
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    eng = InferenceEngine(cfg, EngineConfig(max_batch=4, max_seq=64,
                                            num_aw=2, num_ew=1),
                          seed=7, device="cuda")
    r = np.random.default_rng(0)
    handles = []
    for i, (n, new) in enumerate(((9, 8), (5, 12), (12, 6))):
        frames = r.normal(size=(cfg.encoder_seq, cfg.d_model)).astype(
            np.float32) if cfg.is_encdec else None
        handles.append(eng.client.submit(RequestSpec(
            rid=f"f{i}", prompt=r.integers(1, cfg.vocab_size, size=(n,)),
            max_new=new, frames=frames)))
    eng.step()
    eng.step()
    assert eng.route_state.slot_expert.numel() == 0
    assert _replay_equals_eager(eng, 1).shape == (1, 0)
    while not all(h.done() for h in handles):
        eng.step()
    assert eng.decode_plane.captures() == 1


# ---------------------------------------------------------------------------
# gradients through the kernels (KernelWithPlainGrad): training
# ---------------------------------------------------------------------------

def _grads_of(fn, inputs, douts):
    """(outputs, gradients of every floating input) of sum(out * dout)."""
    leaves = [t.detach().clone().requires_grad_() if t.is_floating_point()
              else t for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    sum((o.float() * d).sum() for o, d in zip(outs, douts)).backward()
    return outs, [t.grad for t in leaves if t.is_floating_point()]


def _f32(inputs):
    """The floating inputs upcast to float32, for the plain version."""
    return [t.float() if t.is_floating_point() else t for t in inputs]


def _close_grads(got, want, tol):
    """``got`` (the Function's outputs and gradients) against ``want``
    (the plain version's, in float32 on the inputs upcast, given the same
    cotangents, exact in the outputs' dtype): rtol ``tol``, atol ``tol``
    times the float32 tensor's RMS, its typical magnitude."""
    (go, gg), (wo, wg) = got, want
    assert all(g is not None for g in gg)
    for a, b in zip(go + tuple(gg), wo + tuple(wg)):
        a, b = a.detach(), b.detach()
        rms = float(b.square().mean().sqrt())
        torch.testing.assert_close(a.float(), b, rtol=tol, atol=tol * rms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,dh,window", [(2, 100, 8, 2, 64, 0),
                                                 (1, 200, 12, 2, 128, 0),
                                                 (2, 72, 4, 4, 112, 32)])
def test_flash_gradient_through_the_kernel(dev, dtype, b, s, h, hkv, dh,
                                           window):
    """A call that needs a gradient launches the kernel in the forward
    pass (S not a multiple of the tile, a padded tail); its output and
    the gradients of q, k and v match the plain version differentiated
    directly in float32."""
    r = np.random.default_rng(s + dh)
    q = _randn(r, (b, s, h, dh), dtype, dev)
    k, v = (_randn(r, (b, s, hkv, dh), dtype, dev) for _ in range(2))
    p = torch.arange(s, device=dev, dtype=torch.int32).repeat(b, 1)
    p[-1, s - 9:] = -1
    dout = [_randn(r, (b, s, h, dh), dtype, dev).float()]
    kw = dict(window=window, causal=True)
    n = fa.KERNEL.launches
    got = _grads_of(lambda q, k, v: ops.full_attention(q, k, v, p, p, **kw),
                    [q, k, v], dout)
    assert fa.KERNEL.launches == n + 1
    want = _grads_of(lambda q, k, v: blockwise_attention(q, k, v, p, p, **kw),
                     _f32([q, k, v]), dout)
    _close_grads(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [24, 130])
def test_expert_ffn_gradient_through_the_kernel_with_shadows(dev, dtype, c):
    """Eight slots over four stored experts: slots 4-6 shadow experts 0,
    1 and 0 again, slot 7 is empty. The kernel runs the forward pass (its
    tile path); the gradients of x and of the stored banks, which sum
    every slot that reads an expert, match the plain version (the
    gathered slot bank) differentiated directly in float32."""
    r = np.random.default_rng(c)
    p, d, f, e = 8, 96, 160, 4
    x = _randn(r, (p, c, d), dtype, dev)
    wg, wu = (_randn(r, (e, d, f), dtype, dev, 0.1) for _ in range(2))
    wd = _randn(r, (e, f, d), dtype, dev, 0.1)
    se = torch.tensor([0, 1, 2, 3, 0, 1, 0, -1], dtype=torch.int32,
                      device=dev)
    cnt = torch.tensor([c, 3, 0, c, 5, 1, c, 0], dtype=torch.int32,
                       device=dev)
    dout = [_randn(r, (p, c, d), dtype, dev).float()]
    n = mg.path_launches["tensor_core"] + mg.path_launches["cuda_core"]
    got = _grads_of(lambda *w: ops.expert_ffn(*w, se, cnt, decode=False),
                    [x, wg, wu, wd], dout)
    assert mg.path_launches["tensor_core"] + \
        mg.path_launches["cuda_core"] == n + 1
    want = _grads_of(lambda *w: mg.expert_ffn_plain(*w, se, cnt),
                     _f32([x, wg, wu, wd]), dout)
    _close_grads(got, want, TOL[dtype])
    assert float(got[1][0][2].abs().max()) == 0.0     # slot 2: no token
    assert float(got[1][1][2].abs().max()) == 0.0     # expert 2: slot 2


@pytest.mark.parametrize("bs,s,h,p,n,chunk", [(2, 128, 8, 64, 64, 64),
                                              (1, 96, 3, 16, 32, 32)])
def test_ssm_scan_gradient_through_the_kernel(dev, bs, s, h, p, n, chunk):
    """The kernel runs the forward pass; y, h_final and the gradients of
    x, dt, a, b and c (through both outputs) match the plain chunked
    scan differentiated directly, at the kernel's float32 bar."""
    r = np.random.default_rng(s + h)
    args = _scan_inputs(r, bs, s, h, p, n, torch.float32, dev)
    douts = [_randn(r, (bs, s, h, p), torch.float32, dev),
             _randn(r, (bs, h, p, n), torch.float32, dev)]
    launches = ss.KERNEL.launches
    got = _grads_of(lambda *t: ops.ssm_scan(*t, chunk=chunk), args, douts)
    assert ss.KERNEL.launches == launches + 1
    want = _grads_of(lambda *t: kref.ssm_scan_chunked_ref(*t, chunk=chunk),
                     _f32(args), douts)
    _close_grads(got, want, 2e-4)


def test_no_gradient_no_function(dev):
    """Without a gradient to take (grad mode off, or no input that
    requires one), the kernels are called directly: their outputs carry
    no autograd history, as on every serving path."""
    r = np.random.default_rng(0)
    q = _randn(r, (1, 64, 4, 64), torch.bfloat16, dev).requires_grad_()
    p = torch.arange(64, device=dev, dtype=torch.int32)[None]
    with torch.no_grad():
        assert ops.full_attention(q, q, q, p, p).grad_fn is None
    assert ops.full_attention(q.detach(), q.detach(), q.detach(), p,
                              p).grad_fn is None
    assert type(ops.full_attention(q, q, q, p, p).grad_fn).__name__ == \
        "KernelWithPlainGradBackward"


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "zamba2_7b"])
def test_bf16_train_step_launches_the_kernels(dev, arch):
    """A reduced bf16 train step: the forward pass launches flash and the
    expert FFN (Mixtral) or the SSD scan (Zamba2), the loss is finite,
    the step counts 1 and every param leaf got a gradient."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.workloads import lm_batches
    from repro_torch.models import get_model
    from repro_torch.training import init_opt_state, make_train_step
    from repro_torch.training.train import loss_and_grads, tree_leaves
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    api = get_model(cfg, num_aw=1, num_ew=2, device="cuda")
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0))
    rs = api.init_route_state()
    batch = next(lm_batches(cfg.vocab_size, 2, 64, 1, seed=1))
    n = {k.symbol: k.launches for k in (fa.KERNEL, mg.KERNEL, ss.KERNEL)}
    _, grads = loss_and_grads(api, params, batch, rs, aux_coef=0.01)
    ran = {k.symbol: k.launches - n[k.symbol]
           for k in (fa.KERNEL, mg.KERNEL, ss.KERNEL)}
    want = {"mixtral_8x7b": ("flash_attention", "moe_ffn"),
            "zamba2_7b": ("flash_attention", "ssm_scan")}[arch]
    assert all(ran[k] > 0 for k in want), ran
    assert all(g is not None for g in tree_leaves(grads))
    params2, opt, loss = make_train_step(api, lr=3e-3)(
        params, init_opt_state(params), batch, rs)
    assert torch.isfinite(loss) and int(opt.step) == 1


def test_sharded_engine_on_a_one_rank_nccl_mesh(dev):
    """Reduced bf16 Mixtral (capacity factor 4.0) served from the
    Sharder's local shards on a 1x1 mesh over a 1-rank NCCL group: greedy
    streams bitwise the unsharded engine's, with and without fail_ew(0);
    the group is gone after its block."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.sharding import Sharder, local_shards
    from repro_torch.models import get_model
    from repro_torch.serving.api import RequestSpec
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = get_config("mixtral_8x7b").reduced()
    cfg = dataclasses.replace(cfg, dtype="bfloat16", moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    ecfg = EngineConfig(max_batch=4, max_seq=64, num_aw=2, num_ew=2)
    r = np.random.default_rng(0)
    prompts = [r.integers(1, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (9, 17, 30, 5)]

    def serve(eng, fail):
        hs = [eng.client.submit(RequestSpec(rid=f"r{i}", prompt=p,
                                            max_new=12))
              for i, p in enumerate(prompts)]
        steps = 0
        while not all(h.done() for h in hs):
            if fail and steps == 4:
                eng.fail_ew(0)
            eng.step()
            steps += 1
        out = [h.tokens() for h in hs]
        for h in reversed(hs):
            eng.release_request(h.rid)
        return out
    plain = InferenceEngine(cfg, ecfg, seed=0, device="cuda")
    want = [serve(plain, False), serve(plain, True)]
    with lmesh.single_rank_group("cuda"):
        mesh = lmesh.make_debug_mesh()
        api = get_model(cfg, num_aw=2, num_ew=2, device="cuda")
        params = Sharder(cfg, mesh).shard_params(api.init_params(
            torch.Generator(device="cuda").manual_seed(0)))
        eng = InferenceEngine(cfg, ecfg, params=local_shards(params),
                              device="cuda")
        assert [serve(eng, False), serve(eng, True)] == want
    assert not dist.is_initialized()


def test_op_count_sees_the_kernel_launches(dev):
    """A reduced bf16 Mixtral prefill and decode step under an
    OpCounter: flash, the expert FFN and the fused decode attention report
    one entry per launch with the kernel modules' work, and the counted
    flops are within the CPU bands of the analytic count."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.roofline.analysis import served_work
    from repro_torch.roofline.op_count import OpCounter
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = get_config("mixtral_8x7b").reduced()
    cfg = dataclasses.replace(cfg, dtype="bfloat16", moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    eng = InferenceEngine(cfg, EngineConfig(max_batch=8, max_seq=96,
                                            num_aw=2, num_ew=2),
                          device="cuda")
    toks = torch.randint(1, cfg.vocab_size, (8, 32), dtype=torch.int32,
                         device=dev)
    cap = eng.prefill_capacity(toks.numel())
    n = {k.symbol: k.launches for k in (fa.KERNEL, mg.KERNEL, da.KERNEL)}
    with OpCounter() as pre:
        _, cache, _ = eng.api.prefill(eng.params, toks, eng.route_state, 96,
                                      capacity=cap)
    pos = torch.full((8,), 32, dtype=torch.int32, device=dev)
    with OpCounter() as dec:
        eng.api.decode(eng.params, toks[:, -1].contiguous(), pos, cache,
                       eng.route_state)
    ran = {k.symbol: k.launches - n[k.symbol]
           for k in (fa.KERNEL, mg.KERNEL, da.KERNEL)}
    assert pre.kernels["flash_attention"][0] == cfg.num_layers
    assert pre.kernels["moe_ffn"][0] == cfg.num_layers
    assert dec.kernels["decode_attention_fused"][0] == cfg.num_layers
    assert dec.kernels["moe_ffn"][0] == cfg.num_layers
    assert ran == {"flash_attention": cfg.num_layers,
                   "moe_ffn": 2 * cfg.num_layers,
                   "decode_attention_fused": cfg.num_layers}
    w_pre = served_work(eng, "prefill", rows=8, seq=32, capacity=cap)
    w_dec = served_work(eng, "decode", rows=8, ctx=[33] * 8)
    assert 0.8 <= pre.flops / w_pre.flops <= 1.1
    assert 0.8 <= dec.flops / w_dec.flops <= 1.1
