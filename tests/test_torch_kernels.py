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
from repro.kernels.decode_attention import (decode_attention_fused,
                                            decode_attention_partial)
from repro.kernels.flash_attention import flash_attention
from repro.kernels.moe_gemm import moe_gemm
from repro.models.attention import blockwise_attention as jblockwise
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import (
    combine_decode_partials, decode_attention_partial_plain,
    decode_attention_plain, merge_split_partials)
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


@pytest.mark.parametrize("dh", [80, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 6])
def test_decode_partial_plain_vs_reference_and_pallas(dh, g):
    """The partial kernel's plain version (what the CUDA kernel is held
    to) against the reference's oracle and the TPU kernel itself
    (interpret mode), at the head dims and group sizes of Gemma2 (256,
    G 2), Danube (80, G 4) and Qwen2 (128, G 6), with a window and a
    softcap."""
    args = _decode_inputs(dh + g, 2, 2 * g, 2, dh, 48)
    q, ck, cv, cpos, _, _, pos = args
    kw = dict(window=24, softcap=50.0)
    got = decode_attention_partial_plain(*_t(q, ck, cv, cpos, pos), **kw)
    want = jref.decode_attention_partial_ref(*_j(q, ck, cv, cpos, pos), **kw)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **TOL)
    want = decode_attention_partial(*_j(q, ck, cv, cpos, pos), block_k=16,
                                    interpret=True, **kw)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **TOL)
    assert [tuple(t.shape) for t in got] == [(2, 2, g), (2, 2, g),
                                            (2, 2, g, dh)]


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 50.0)])
def test_decode_partials_split_along_sc_merge_to_the_whole(window, softcap):
    """The partial kernel's one use: a cache split in two along Sc, each
    half's partials merged and then combined, gives the reference's
    decode attention over the whole cache."""
    args = _decode_inputs(11, 2, 12, 2, 80, 64)
    q, ck, cv, cpos, k1, v1, pos = _t(*args)
    kw = dict(window=window, softcap=softcap)
    parts = [decode_attention_partial_plain(q, ck[:, a:z], cv[:, a:z],
                                            cpos[:, a:z], pos, **kw)
             for a, z in ((0, 32), (32, 64))]
    got = combine_decode_partials(q, *merge_split_partials(parts), k1, v1,
                                  softcap=softcap)
    want = jref.decode_attention_ref(*_j(*args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_partial_row_without_keys():
    """A row with no valid key (pos -1): the plain version (and the CUDA
    kernel) gives m = -1e30, l = 0, acc = 0; the TPU kernel l = Sc and acc
    = the sum of V, its masked scores having counted exp(0) while m was
    still -1e30. The combine sends both to the same output, since the
    correction exp(-1e30 - s_self) is 0; rows with a key agree."""
    q, ck, cv, cpos, k1, v1, pos = _decode_inputs(5, 2, 4, 2, 32, 64)
    pos[0] = -1
    plain = decode_attention_partial_plain(*_t(q, ck, cv, cpos, pos))
    tpu = decode_attention_partial(*_j(q, ck, cv, cpos, pos), block_k=16,
                                   interpret=True)
    m, l, acc = (t.numpy() for t in plain)
    np.testing.assert_array_equal(m[0], np.full_like(m[0], -1e30))
    np.testing.assert_array_equal(l[0], 0.0)
    np.testing.assert_array_equal(acc[0], 0.0)
    tm, tl, tacc = (np.asarray(t) for t in tpu)
    np.testing.assert_array_equal(tm[0], np.full_like(tm[0], -1e30))
    np.testing.assert_array_equal(tl[0], 64.0)
    np.testing.assert_allclose(
        tacc[0], np.broadcast_to(cv[0].sum(0)[:, None], tacc[0].shape),
        rtol=1e-5, atol=1e-4)
    for a, b in zip(plain, tpu):          # rows with a valid key
        np.testing.assert_allclose(a.numpy()[1], np.asarray(b)[1],
                                   rtol=2e-6, atol=2e-6)
    tq, tk1, tv1 = _t(q, k1, v1)
    out_plain = combine_decode_partials(tq, *plain, tk1, tv1)
    out_tpu = combine_decode_partials(
        tq, *(torch.tensor(np.asarray(t)) for t in tpu), tk1, tv1)
    np.testing.assert_array_equal(out_plain.numpy()[0], out_tpu.numpy()[0])
    # a row with no cached key attends to its own token alone
    np.testing.assert_allclose(
        out_plain.numpy()[0],
        np.repeat(v1[0], 2, axis=0), rtol=1e-6, atol=1e-6)


def _split_case(kind):
    """Three rows over a 640-position cache: row 0 without a valid key
    (pos -1), row 1 whose keys end at position 100 (every later split
    all masked), row 2 over the whole cache; "ring": a wrapped 640-slot
    ring of a 200-token window (row 2 at position 1500, row 1 not yet
    wrapped), "softcap": the contiguous cache with a softcap of 30."""
    q, ck, cv, cpos, k1, v1, _ = _decode_inputs(17, 3, 8, 2, 32, 640)
    ar = np.arange(640)[None]
    if kind == "ring":
        pos = np.array([-1, 100, 1500], np.int32)
        last = np.maximum(pos - 1, 0)[:, None]
        cpos = np.where(ar <= last, last - (last - ar) % 640, -1)
        return (q, ck, cv, cpos.astype(np.int32), k1, v1, pos), \
            dict(window=200)
    pos = np.array([-1, 100, 639], np.int32)
    cpos = np.where(ar < pos[:, None], ar, -1).astype(np.int32)
    cpos[2, 300:340] = -1                 # a hole: a masked tile mid-cache
    return (q, ck, cv, cpos, k1, v1, pos), \
        dict(softcap=30.0 if kind == "softcap" else 0.0)


@pytest.mark.parametrize("split", [16, 64, 128, 256])
@pytest.mark.parametrize("kind", ["contiguous", "ring", "softcap"])
def test_split_partials_merge_to_the_fused_reference(split, kind):
    """The bf16 kernels' arithmetic in plain float32 (at their split size,
    128, and others): the cache's plain partials per range of ``split``
    positions from index 0, merged in range order and combined with the
    current token, against the JAX
    fused kernel (interpret mode) and its reference at 2e-5; rows with no
    valid key, with every later split masked, a window over a wrapped
    ring and a softcap."""
    args, kw = _split_case(kind)
    q, ck, cv, cpos, k1, v1, pos = _t(*args)
    parts = [decode_attention_partial_plain(
        q, ck[:, a:a + split], cv[:, a:a + split], cpos[:, a:a + split], pos,
        **kw) for a in range(0, 640, split)]
    got = combine_decode_partials(q, *merge_split_partials(parts), k1, v1,
                                  softcap=kw.get("softcap", 0.0))
    want = decode_attention_fused(*_j(*args), block_k=128, interpret=True,
                                  **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jref.decode_attention_ref(*_j(*args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy()[0],
                                  np.repeat(args[5][0], 4, axis=0))


def _partial_case(kind):
    """The partial kernel's inputs (q, ck, cv, cpos, pos) and keywords:
    ``_split_case``'s three 640-position caches, or "long": 4,608
    positions (36 ranges of 128, past the merge's chunk of 32 splits),
    row 0 without a valid key, row 1's keys ending at position 1000 and
    row 2 over the whole cache with a hole of 300 positions."""
    if kind != "long":
        (q, ck, cv, cpos, _, _, pos), kw = _split_case(kind)
        return (q, ck, cv, cpos, pos), kw
    q, ck, cv, _, _, _, _ = _decode_inputs(19, 3, 8, 2, 32, 4608)
    pos = np.array([-1, 1000, 4600], np.int32)
    ar = np.arange(4608)[None]
    cpos = np.where(ar < pos[:, None], ar, -1).astype(np.int32)
    cpos[2, 2000:2300] = -1
    return (q, ck, cv, cpos, pos), {}


@pytest.mark.parametrize("kind", ["contiguous", "ring", "softcap", "long"])
def test_split_partials_merge_to_the_partial_kernel(kind):
    """The bf16 partial kernel's arithmetic in plain float32: the cache's
    plain partials per 128-position range from index 0, merged in range
    order with no combine, against the JAX partial kernel (interpret mode,
    block_k 128) and its reference at 2e-5: m and l directly, acc as acc
    / l. A row with no valid key merges to m = -1e30, l = 0, acc = 0
    exactly, the reference's values (the TPU kernel's differ there; see
    test_decode_partial_row_without_keys), so only rows with a key are
    held to the TPU kernel."""
    args, kw = _partial_case(kind)
    q, ck, cv, cpos, pos = args
    sc = ck.shape[1]
    tq, tck, tcv, tcpos, tpos = _t(*args)
    parts = [decode_attention_partial_plain(
        tq, tck[:, a:a + 128], tcv[:, a:a + 128], tcpos[:, a:a + 128], tpos,
        **kw) for a in range(0, sc, 128)]
    assert len(parts) == (36 if kind == "long" else 5)
    got = [t.numpy() for t in merge_split_partials(parts)]
    ref = [np.asarray(t) for t in jref.decode_attention_partial_ref(
        *_j(*args), **kw)]
    tpu = [np.asarray(t) for t in decode_attention_partial(
        *_j(*args), block_k=128, interpret=True, **kw)]
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    if kw.get("window"):
        valid &= cpos > pos[:, None] - kw["window"]
    keys = valid.any(1)
    assert not keys[0] and keys[1:].all()

    def close(want, rows):
        for a, b in zip(got[:2], want[:2]):           # m, l
            np.testing.assert_allclose(a[rows], b[rows], **TOL)
        np.testing.assert_allclose(got[2][rows] / got[1][rows][..., None],
                                   want[2][rows] / want[1][rows][..., None],
                                   **TOL)
    close(ref, keys)
    close(tpu, keys)
    m, l, acc = got
    np.testing.assert_array_equal(m[0], np.full_like(m[0], -1e30))
    np.testing.assert_array_equal(l[0], 0.0)
    np.testing.assert_array_equal(acc[0], 0.0)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("at", ["end", "middle", "front"])
def test_an_all_masked_split_changes_no_bit(at):
    """A split with no valid key (m = NEG_INF, l = 0, acc = 0) is skipped
    by the merge: adding one (a larger cache, a masked range) changes no
    bit of the merged partials or of the output."""
    args, kw = _split_case("contiguous")
    q, ck, cv, cpos, k1, v1, pos = _t(*args)
    parts = [decode_attention_partial_plain(q, ck[:, a:a + 64],
                                            cv[:, a:a + 64],
                                            cpos[:, a:a + 64], pos)
             for a in range(0, 640, 64)]
    masked = decode_attention_partial_plain(q, ck[:, :64], cv[:, :64],
                                            torch.full_like(cpos[:, :64], -1),
                                            pos)
    assert bool((masked[0] == tref.NEG_INF).all()) and \
        not masked[1].any() and not masked[2].any()
    i = {"end": len(parts), "middle": 4, "front": 0}[at]
    base = merge_split_partials(parts)
    more = merge_split_partials(parts[:i] + [masked] + parts[i:])
    for a, b in zip(base, more):
        assert torch.equal(a, b)
    assert torch.equal(combine_decode_partials(q, *base, k1, v1),
                       combine_decode_partials(q, *more, k1, v1))


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


# (gated, act, C, slot layout): the prefill-sized call of six slots, and
# the decode shapes (C 1, 2, 4 and 8) over 16 slots: 4 primaries, their
# shadows, a -1 slot and empty slots
FFN_CASES = [(True, "silu", 16, "six"), (False, "gelu", 16, "six")] + [
    (gated, act, c, "shadows") for c in (1, 2, 4, 8)
    for gated, act in ((True, "silu"), (False, "gelu"))]
FFN_SLOTS = {
    "six": ([0, 1, 2, 3, 1, -1], [3, 0, 16, 1, 2, 5]),
    "shadows": ([0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3, -1, 1, 2, 3],
                [8, 1, 0, 8, 8, 0, 0, 2, 0, 0, 0, 0, 5, 0, 8, 0]),
}


@pytest.mark.parametrize(
    "gated,act,c,slots", FFN_CASES,
    ids=[f"{g}-{a}" + ("" if sl == "six" else f"-decode-C{c}")
         for g, a, c, sl in FFN_CASES])
def test_expert_ffn_plain_vs_pallas(gated, act, c, slots):
    """The port's expert FFN takes the stored bank plus slot_expert; the
    reference's model path gathers the slot bank first and then runs the
    TPU kernel. Slots with count 0 are 0 in both, and a -1 slot reads
    expert 0 as the reference's gather does; a shadow slot's rows equal
    its primary's on the same tokens."""
    r = np.random.default_rng(5 if slots == "six" else 5 + c)
    d, f, e = 32, 64, 4
    slot_expert = np.array(FFN_SLOTS[slots][0], np.int32)
    counts = np.minimum(np.array(FFN_SLOTS[slots][1], np.int32), c)
    p = len(slot_expert)
    x = r.normal(size=(p, c, d)).astype(np.float32)
    if slots == "shadows":
        x[4:8] = x[:4]                  # shadows see their primaries' tokens
    bank = {k: (r.normal(size=shape) * 0.1).astype(np.float32)
            for k, shape in (("wg", (e, d, f)), ("wu", (e, d, f)),
                             ("wd", (e, f, d)))}
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
    for q in np.flatnonzero(counts == 0):
        assert float(got[q].abs().max()) == 0.0
    if slots == "shadows":
        assert torch.equal(got[4], got[0]) and torch.equal(got[7], got[3])
    # ops dispatch: a [P, G, C / G, D] batch flattens and comes back
    grp = 2 if c % 2 == 0 else 1
    got4 = tops.expert_ffn(torch.from_numpy(x).reshape(p, grp, c // grp, d),
                           torch.from_numpy(bank["wg"]) if gated else None,
                           torch.from_numpy(bank["wu"]),
                           torch.from_numpy(bank["wd"]),
                           torch.from_numpy(slot_expert),
                           torch.from_numpy(counts), decode=c <= 8,
                           act=act)
    np.testing.assert_allclose(got4.reshape(p, c, d).numpy(), got.numpy(),
                               rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_path_without_building():
    """Dispatch by device: CPU tensors never touch nvcc or ctypes."""
    from repro_torch.kernels import build
    args = _t(*_decode_inputs(1, 1, 4, 2, 32, 16))
    tops.decode_attention(*args)
    assert build._libs == {}
