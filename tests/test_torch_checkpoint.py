"""The port's checkpoint store and AW-side checkpointer against the JAX
``core/checkpoint.py`` on the same inputs (float32 segments, handed to
the reference as numpy and to the port as torch), and the port's segment
path through its cache layouts: a bfloat16 segment restores bit for bit,
from a paged layout into a contiguous one."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.checkpoint import CheckpointStore as JStore
from repro.core.checkpoint import KVCheckpointer as JCheckpointer
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.core.checkpoint import CheckpointStore, KVCheckpointer
from repro_torch.models import get_model
from repro_torch.serving.kvcache import CacheLayout, PagedCacheLayout, \
    PagePool


def _seg(i):
    return np.full((4,), i, np.float32)


def _both(fn):
    """Run ``fn(store, seg)`` on a JAX store with numpy segments and on a
    port store with torch segments; return both results."""
    return (fn(JStore(), _seg),
            fn(CheckpointStore(), lambda i: torch.from_numpy(_seg(i))))


def _stats(s):
    st = s.stats
    return (st.bytes_written, st.bytes_restored, st.updates, st.out_of_order,
            st.restores)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_watermark_is_the_contiguous_prefix(seed):
    """Segments delivered in any order: after every delivery the commit
    watermark is the end of the contiguous seq prefix, as in the
    reference."""
    order = np.random.default_rng(seed).permutation(8)

    def run(s, seg):
        s.register_request("r", aw_id=0)
        seqs = [s.next_seq("r") for _ in range(8)]
        marks = []
        for i in order:
            s.async_update("r", int(i), seg(i), seqs[i], 100 + int(i))
            marks.append(s.committed_token("r"))
        return marks, _stats(s)

    (jm, js), (tm, ts) = _both(run)
    assert tm == jm and ts == js
    assert tm[-1] == 7


def test_restore_truncates_the_log_to_the_commit_record():
    """Restoration keeps only the committed prefix and restarts the
    sequence numbers after it: a WR from past the watermark that arrives
    after the restore is gone, so the gap at seq 1, once filled, commits
    token 1 and no further. This is what the code does (and what failover
    relies on: a dropped WR would otherwise leave a permanent gap)."""
    def run(s, seg):
        s.register_request("r", aw_id=0)
        seqs = [s.next_seq("r") for _ in range(4)]
        s.async_update("r", 0, seg(0), seqs[0], 100)
        s.async_update("r", 2, seg(2), seqs[2], 102)    # seq 1 missing
        s.async_update("r", 3, seg(3), seqs[3], 103)
        before = s.committed_token("r")
        c, tv, segs = s.restore_request("r")
        restart = s.next_seq("r")
        s.async_update("r", 1, seg(1), seqs[1], 101)    # the gap fills
        return (before, c, tv, sorted(segs), restart,
                s.committed_token("r"), _stats(s))

    want, got = _both(run)
    assert got == want
    assert got[:6] == (0, 0, 100, [0], 1, 1)


def _ck_calls(ck_cls, store, reorder):
    ck = ck_cls(store, aw_id=0, reorder_window=reorder)
    calls = []
    inner = ck.checkpoint_range

    def spy(rid, start, seg_stack, token_values):
        calls.append((start, len(token_values)))
        inner(rid, start, seg_stack, token_values)

    ck.checkpoint_range = spy
    return ck, calls


def test_checkpoint_blocks_split_at_page_boundaries():
    """A 9-token run from token 5 on 4-token pages streams as the page
    pieces [5, 8), [8, 12), [12, 14), each token with its own seq."""
    seg = np.arange(9 * 3, dtype=np.float32).reshape(9, 3)
    results = []
    for store, ck_cls, stack in (
            (JStore(), JCheckpointer, [seg]),
            (CheckpointStore(), KVCheckpointer, [torch.from_numpy(seg)])):
        ck, calls = _ck_calls(ck_cls, store, 0)
        ck.register("r")
        ck.checkpoint_blocks("r", 5, stack, list(range(200, 209)), 4)
        c, tv, segs = store.restore_request("r")
        results.append((calls, c, tv, sorted(segs),
                        [np.asarray(segs[t][0]).tolist()
                         for t in sorted(segs)]))
    assert results[1] == results[0]
    assert results[1][0] == [(5, 3), (8, 4), (12, 2)]
    assert results[1][1:3] == (13, 208)


def test_drop_pending_and_drop_request():
    """Pending WRs (reorder window 8): ``drop_request`` discards one
    request's and keeps the other's; ``drop_pending`` (a crash) loses the
    rest, so nothing past the delivered prefix commits."""
    results = []
    for store, ck_cls, seg in (
            (JStore(), JCheckpointer, _seg),
            (CheckpointStore(), KVCheckpointer,
             lambda i: torch.from_numpy(_seg(i)))):
        ck = ck_cls(store, aw_id=0, reorder_window=8)
        for rid in ("a", "b"):
            ck.register(rid)
        for t in range(3):
            ck.checkpoint_token("a", t, [seg(t)], token_value=t)
            ck.checkpoint_token("b", t, [seg(t)], token_value=t)
        dropped_b = ck.drop_request("b")
        pend = (ck.pending_for("a"), ck.pending_for("b"))
        ck.flush()
        ck.checkpoint_token("a", 3, [seg(3)], token_value=3)
        lost = ck.drop_pending()
        results.append((dropped_b, pend, lost, store.committed_token("a"),
                        store.committed_token("b"), _stats(store)))
    assert results[1] == results[0]
    assert results[1][:5] == (3, (3, 0), 1, 2, -1)


# --------------------------------------------------------------------------
# segments through the port's cache layouts
# --------------------------------------------------------------------------

def _bf16_api():
    cfg = dataclasses.replace(get_config("mixtral_8x7b").reduced(),
                              dtype="bfloat16")
    return get_model(cfg, num_aw=2, num_ew=2, device="cpu")


def _fill(cache, g, page):
    """Random K/V, with a negative zero, a subnormal and a near-max value
    at the start of ``page``."""
    for layer in cache["layers"]:
        for name in ("k", "v"):
            t = layer[name]
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
            t[page].view(-1)[:3] = torch.tensor([-0.0, 1e-40, -3.0e38],
                                                dtype=t.dtype)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_bf16_segments_restore_bit_exact_across_layouts():
    """bfloat16 K/V (a negative zero, a subnormal, a near-max value
    included) checkpointed from a paged cache through the store restore
    bit for bit into another slot of a contiguous cache."""
    api = _bf16_api()
    g = torch.Generator().manual_seed(0)
    max_seq, pt = 32, 8
    pool = PagePool(4, 2, max_seq // pt, pt)
    paged = PagedCacheLayout(pool, max_seq)
    pcache = paged.make_cache(api.init_cache, 4)
    slot, n = 1, 19
    for blk in range(-(-n // pt)):
        pool.map_block(slot, blk, pool.alloc(0))
    paged.set_block_table(pcache, pool.bt)
    _fill(pcache, g, int(pool.bt[slot, 0]))
    for layer in pcache["layers"]:
        for blk in range(-(-n // pt)):
            layer["pos"][pool.bt[slot, blk]] = torch.arange(
                blk * pt, (blk + 1) * pt, dtype=torch.int32)

    store = CheckpointStore()
    ck = KVCheckpointer(store, aw_id=0)
    ck.register("r")
    ck.checkpoint_blocks("r", 0, paged.extract_range(pcache, slot, 0, n),
                         list(range(n)), pt)
    c, _, segs = store.restore_request("r")
    assert c == n - 1 and sorted(segs) == list(range(n))

    contig = CacheLayout()
    ccache = api.init_cache(4, max_seq)
    contig.write_token_segments(ccache, 3, list(segs), list(segs.values()))
    view = paged.extract_range(pcache, slot, 0, n)
    back = contig.extract_range(ccache, 3, 0, n)
    for a, b in zip(view, back):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert _bits(back[0][0, 0, 0].reshape(-1)[:3]).tolist() == \
        _bits(torch.tensor([-0.0, 1e-40, -3.0e38],
                           dtype=torch.bfloat16)).tolist()
    for li, layer in enumerate(ccache["layers"]):
        assert layer["pos"][3, :n].tolist() == list(range(n))
        assert bool((layer["pos"][3, n:] == -1).all())
        rows = [pool.bt[slot, t // pt] for t in range(n)]
        offs = [t % pt for t in range(n)]
        for name in ("k", "v"):
            assert torch.equal(_bits(layer[name][3, :n]),
                               _bits(pcache["layers"][li][name][rows, offs]))
    # a token whose page is unmapped is dropped, never written to page 0
    before = [layer["k"][0].clone() for layer in pcache["layers"]]
    paged.write_token_segments(pcache, 2, [0], [segs[0]])
    for b0, layer in zip(before, pcache["layers"]):
        assert torch.equal(_bits(b0), _bits(layer["k"][0]))
        assert bool((layer["pos"][0] == -1).all())
