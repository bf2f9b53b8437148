"""The engine options and helpers the port takes from the reference's
``EngineConfig`` and planes, against the JAX package: the engine-level
sampling defaults (greedy, temperature, top_k), ``capacity_factor_decode``,
``prefill_bucket`` and its divisibility check under chunked prefill,
``checkpoint_reorder``, and ``ClusterSlotView``'s slot methods,
``PlacementPlan.replica_of`` / ``moved_slots``, ``push_seconds`` and
``GatewayStats.class_count``. Twins of ``tests/test_sampling.py``,
``test_chunked_prefill.py`` and the helpers' uses in the reference's
tests; on reduced Mixtral at capacity factor 4.0 unless stated."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.placement import PlacementPlan as JPlan
from repro.core.placement import push_seconds as j_push_seconds
from repro.serving.api import RequestSpec as JRequestSpec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.gateway import GatewayStats as JGatewayStats
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.placement import PlacementPlan, push_seconds
from repro_torch.serving.api import RequestSpec
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.gateway import GatewayStats

PROMPT = np.arange(1, 9, dtype=np.int32)


def _cap(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def ref_engine(cf=4.0, key=2, **kw):
    ecfg = JEngineConfig(**{**dict(max_batch=4, max_seq=48, num_aw=2,
                                   num_ew=2, telemetry=False,
                                   flight_recorder=False), **kw})
    return JEngine(_cap(jget_config("mixtral_8x7b").reduced(), cf), ecfg,
                   jax.random.PRNGKey(key))


def port_engine(ref=None, cf=4.0, **kw):
    """The port's engine on ``ref``'s weights (or its own seeded ones)."""
    ecfg = EngineConfig(**{**dict(max_batch=4, max_seq=48, num_aw=2,
                                  num_ew=2), **kw})
    params = None if ref is None else params_from_reference(ref.params,
                                                            device="cpu")
    return InferenceEngine(_cap(get_config("mixtral_8x7b").reduced(), cf),
                           ecfg, params=params, device="cpu")


def generate(eng, prompt, max_new, rid="r"):
    h = eng.client.submit(RequestSpec(rid=rid, prompt=prompt,
                                      max_new=max_new))
    while not h.done():
        eng.step()
    out = h.tokens()
    eng.release_request(rid)
    return out


@pytest.fixture(scope="module")
def ref():
    return ref_engine()


# ----------------------------------------------------------------------------
# capacity_factor_decode
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [0.0, 4.0, 1.3, 0.25])
def test_decode_capacity_equals_reference(cf):
    j = ref_engine(capacity_factor_decode=cf)
    t = port_engine(capacity_factor_decode=cf)
    assert t.decode_capacity == j.decode_capacity
    assert port_engine(cf=0.0, capacity_factor_decode=0.0) \
        .decode_capacity is None


@pytest.mark.parametrize("cf", [4.0, 0.25])
def test_greedy_streams_with_capacity_factor_decode_equal_reference(cf):
    """The model's own factor (the same capacity) and a tight one that
    drops tokens at capacity: greedy streams equal the JAX engine's, and
    the decode key takes no new capture once warm."""
    j = ref_engine(capacity_factor_decode=cf)
    t = port_engine(j, capacity_factor_decode=cf)
    want = j.generate("r", PROMPT, 10)
    assert generate(t, PROMPT, 10) == want
    warm = t.decode_plane.captures()
    assert generate(t, PROMPT, 10, rid="again") == want
    assert t.decode_plane.captures() == warm
    if cf == 4.0:
        assert want == ref_engine().generate("r", PROMPT, 10)


# ----------------------------------------------------------------------------
# sampling defaults
# ----------------------------------------------------------------------------
def test_top_k_one_equals_greedy(ref):
    """top_k=1 collapses the distribution to the argmax token; greedy is
    the reference's stream."""
    greedy = generate(port_engine(ref), PROMPT, 10)
    assert greedy == ref.generate("r", PROMPT, 10)
    k1 = generate(port_engine(ref, greedy=False, temperature=0.7, top_k=1,
                              sample_seed=9), PROMPT, 10)
    assert k1 == greedy


def test_sampled_decode_valid_and_seed_deterministic(ref):
    kw = dict(greedy=False, temperature=0.8, top_k=8, sample_seed=5)
    a = generate(port_engine(ref, **kw), PROMPT, 12)
    b = generate(port_engine(ref, **kw), PROMPT, 12)
    assert a == b                       # same sample seed -> same stream
    assert len(a) == 12 and all(0 <= t < ref.cfg.vocab_size for t in a)
    hot = generate(port_engine(ref, greedy=False, temperature=5.0,
                               sample_seed=1), PROMPT, 12)
    assert hot != generate(port_engine(ref), PROMPT, 12)


# ----------------------------------------------------------------------------
# prefill_bucket
# ----------------------------------------------------------------------------
class _Q:
    def __init__(self, n):
        self.prompt = np.ones((n,), np.int32)


@pytest.mark.parametrize("bucket", [16, 8, 5, 32])
def test_prefill_bucket_sets_the_padded_keys(ref, bucket):
    t = port_engine(ref, prefill_bucket=bucket)
    j = ref_engine(prefill_bucket=bucket)
    fresh = [(_Q(n), 0, i) for i, n in enumerate((1, 2, 7, 9, 16, 17, 33))]
    keys = [k for k, _ in t.scheduler._bucket_groups(fresh)]
    assert keys == [k for k, _ in j.scheduler._bucket_groups(fresh)]


def test_padded_prefill_matches_exact_at_tight_capacity():
    """Bucket 16 pads a 21-token prompt's prefill to 32 columns; bucket 20
    pads none. With the validity mask and real-token capacity both give
    the reference's stream at a tight capacity factor."""
    rng = np.random.default_rng(3)
    p = rng.integers(1, 200, size=(21,)).astype(np.int32)
    j = ref_engine(cf=1.0, key=0, max_seq=64, prefill_bucket=16)
    want = j.generate("r", p, 6)
    for bucket in (16, 20):
        assert generate(port_engine(j, cf=1.0, max_seq=64,
                                    prefill_bucket=bucket), p, 6) == want


def test_chunked_prefill_refuses_an_unaligned_bucket():
    kw = dict(chunk_token_budget=8, prefill_bucket=12)
    with pytest.raises(AssertionError, match="multiples of PREFILL_BLOCK_K"):
        ref_engine(**kw)
    with pytest.raises(ValueError, match="multiples of PREFILL_BLOCK_K"):
        port_engine(**kw)


# ----------------------------------------------------------------------------
# checkpoint_reorder
# ----------------------------------------------------------------------------
def test_mid_prefill_failure_recomputes_only_uncommitted_tail():
    """With a reorder window the last chunk's segments are still pending
    on the AW when it dies; they never commit, and exactly that tail is
    recomputed after recovery: the committed token, the recomputed tokens
    and the stream equal the reference's."""
    rng = np.random.default_rng(7)
    p = rng.integers(1, 200, size=(40,)).astype(np.int32)
    n_pre = len(p) - 1
    kw = dict(max_batch=8, max_seq=64, chunk_token_budget=8)
    out = {}
    for side in ("ref", "port"):
        if side == "ref":
            eng = JEngine(_cap(jget_config("mixtral_8x7b").reduced(), 4.0),
                          JEngineConfig(num_aw=2, num_ew=2,
                                        checkpoint_reorder=6,
                                        telemetry=False,
                                        flight_recorder=False, **kw),
                          jax.random.PRNGKey(0))
            jeng = eng
            eng.client.submit(JRequestSpec(rid="r", prompt=p, max_new=5))
        else:
            eng = InferenceEngine(
                _cap(get_config("mixtral_8x7b").reduced(), 4.0),
                EngineConfig(num_aw=2, num_ew=2, checkpoint_reorder=6, **kw),
                params=params_from_reference(jeng.params, device="cpu"),
                device="cpu")
            eng.client.submit(RequestSpec(rid="r", prompt=p, max_new=5))
        r = eng.requests["r"]
        aw0 = r.aw
        eng.chunked.tick(0.0)
        eng.chunked.tick(0.0)
        cursor = r.prefill_cursor
        assert cursor == 16
        assert len(eng.aws[aw0].checkpointer._pending) > 0
        eng.fail_aw(aw0)
        committed = eng.store.committed_token("r")
        assert 0 <= committed < cursor - 1
        eng.recover_aw_requests(now=1.0)
        assert r.prefill_cursor == committed + 1
        n = 0
        while (eng.active_requests() or eng.prefilling_requests()
               or eng.gateway.depth()) and n < 500:
            eng.scheduler.admit(float(n))
            eng.step()
            n += 1
        recomputed = eng.chunked.stats.prefilled_tokens["r"] - n_pre
        assert 0 < recomputed < cursor
        out[side] = (committed, recomputed, list(eng.requests["r"].tokens))
    assert out["port"] == out["ref"]


# ----------------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------------
def test_slot_view_equals_reference(ref):
    t = port_engine(ref)
    views = (t.slots, ref_engine().slots)
    for v in views:
        assert [v.aw_of(s) for s in range(4)] == [0, 0, 1, 1]
    got = [[v.alloc(1), v.free_count(1), v.free_count(0)] for v in views]
    assert got[0] == got[1]
    for v in views:
        v.release(got[0][0])
    assert [v.free_count(1) for v in views] == [2, 2]


def test_class_count_equals_reference():
    ours, theirs = GatewayStats(), JGatewayStats()
    for s in (ours, theirs):
        s.bump("interactive", "enqueued")
        s.bump("interactive", "enqueued", 2)
        s.bump("batch", "preempted")
    for cls in ("interactive", "batch", "standard"):
        for key in ("enqueued", "preempted", "admitted"):
            assert ours.class_count(cls, key) == theirs.class_count(cls, key)


def test_plan_helpers_and_push_seconds_equal_reference():
    rng = np.random.default_rng(4)
    e, p = 8, 20
    plans = []
    for gen in range(4):
        arrays = dict(slot_expert=rng.integers(-1, e, p),
                      slot_owner=rng.integers(-1, 4, p),
                      primary=rng.permutation(p)[:e],
                      split_slot=np.full(e, -1), members=(0, 1, 2, 3))
        plans.append((PlacementPlan(gen, **arrays), JPlan(gen, **arrays)))
    for (t, j), (t0, j0) in zip(plans[1:], plans[:-1]):
        assert [t.replica_of(x) for x in range(e)] == \
            [j.replica_of(x) for x in range(e)]
        assert t.moved_slots(t0) == j.moved_slots(j0)
        for gated in (True, False):
            n = t.moved_slots(t0)
            assert push_seconds(n, 4096, 14336, gated=gated) == \
                j_push_seconds(n, 4096, 14336, gated=gated)
    assert push_seconds(3, 128, 64, link_gbps=100.0, bytes_per_el=4) == \
        j_push_seconds(3, 128, 64, link_gbps=100.0, bytes_per_el=4)
