"""The port's REFE routing (``repro_torch.core.refe``) against the JAX
package's: health masks, capacity ranks, replica splits, ties and the
grouped dispatch. Integer outputs must match exactly, gate weights to
1e-6; expert_io's outputs to 2e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ert as jert
from repro.core import refe as jrefe
from repro.core import selfheal as jheal
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.core import ert as tert
from repro_torch.core import refe as trefe
from repro_torch.core import selfheal as theal

# one compiled routing program per static configuration, instead of eager
# per-op dispatch
_jroute = jax.jit(jrefe.route, static_argnames=(
    "placement", "top_k", "capacity_factor", "capacity", "batch"))

EXACT = ("slot_idx", "pos", "keep", "slot_load", "topk_idx", "token_valid",
         "active_slot", "expert_alive")


def _states(num_experts, num_ew, num_aw):
    jp = jert.default_placement(num_experts, num_ew)
    tp = tert.default_placement(num_experts, num_ew)
    assert jp == tp or (jp.num_slots, jp.num_shadow_slots) == \
        (tp.num_slots, tp.num_shadow_slots)
    return (jp, jrefe.RouteState.healthy(jp, num_aw),
            tp, trefe.RouteState.healthy(tp, num_aw, device="cpu"))


def _route_both(logits, js, ts, jp, tp, *, top_k=2, cf=1.25, capacity=None,
                batch=0, mask=None):
    t = logits.shape[0]
    x = np.zeros((t, 4), np.float32)
    kw = dict(top_k=top_k, capacity_factor=cf, capacity=capacity,
              batch=batch)
    jr = _jroute(jnp.asarray(x), jnp.asarray(logits), js, jp,
                 token_mask=None if mask is None else jnp.asarray(mask),
                 **kw)
    tr = trefe.route(torch.from_numpy(x), torch.from_numpy(logits), ts, tp,
                     token_mask=None if mask is None
                     else torch.from_numpy(mask), **kw)
    return jr, tr


def _assert_same(jr, tr):
    for k in EXACT:
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]),
                                      err_msg=k)
    np.testing.assert_allclose(tr["gate_w"].numpy(), np.asarray(jr["gate_w"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tr["aux_loss"]), float(jr["aux_loss"]),
                               rtol=1e-5)
    for k in ("capacity", "num_slots", "grouped", "groups", "group_size"):
        assert tr[k] == jr[k], k


def _logits(seed, t, e):
    return np.random.default_rng(seed).normal(size=(t, e)).astype(np.float32)


def test_placement_tables_match():
    for e, ew in ((8, 2), (4, 2), (60, 16), (8, 4)):
        jp, tp = jert.default_placement(e, ew), tert.default_placement(e, ew)
        assert (jp.num_slots, jp.primary_slots) == (tp.num_slots,
                                                    tp.primary_slots)
        np.testing.assert_array_equal(tp.slot_owner(), jp.slot_owner())
        for prot in range(ew):
            ja = jert.initial_shadow_assignment(jp, prot)
            ta = tert.initial_shadow_assignment(tp, prot)
            np.testing.assert_array_equal(ta, ja)
            np.testing.assert_array_equal(tert.build_candidates(tp, ta),
                                          jert.build_candidates(jp, ja))
            np.testing.assert_array_equal(tert.initial_slot_expert(tp, ta),
                                          jert.initial_slot_expert(jp, ja))


@pytest.mark.parametrize("case", ["healthy", "fail_ew0", "fail_ew1",
                                  "fail_aw1", "tight", "split", "masked"])
def test_route_matches_reference(case):
    jp, js, tp, ts = _states(8, 2, 2)
    logits = _logits(len(case) * 31 + ord(case[-1]), 16, 8)
    kw = {}
    if case == "fail_ew0":                 # protected EW: shadows take over
        js, ts = jheal.fail_ew(js, 0), theal.fail_ew(ts, 0)
    elif case == "fail_ew1":               # unprotected EW: experts die
        js, ts = jheal.fail_ew(js, 1), theal.fail_ew(ts, 1)
    elif case == "fail_aw1":
        js, ts = jheal.fail_aw(js, 1), theal.fail_aw(ts, 1)
        kw["batch"] = 8
    elif case == "tight":
        kw["cf"] = 0.5
    elif case == "split":
        split = np.full((8,), -1, np.int32)
        split[2], split[5] = 9, 12         # replicas on the other EW
        js = js._replace(split_slot=jnp.asarray(split))
        ts = ts._replace(split_slot=torch.from_numpy(split))
        kw["cf"] = 0.75
    elif case == "masked":
        mask = np.ones((16,), bool)
        mask[[1, 4, 5, 11]] = False
        kw["mask"] = mask
    jr, tr = _route_both(logits, js, ts, jp, tp, **kw)
    _assert_same(jr, tr)
    if case == "tight":
        assert not bool(tr["keep"][tr["gate_w"] > 0].all())  # drops happen


def test_route_ties_break_to_lowest_index():
    """Dead-expert masking zeroes probabilities, so top-3 over 8 experts
    with EW1's 4 unprotected experts dead picks among exact-zero ties; and
    rows of equal logits tie everywhere. jax.lax.top_k takes the lowest
    index first, and so must the port."""
    jp, js, tp, ts = _states(8, 2, 1)
    js, ts = jheal.fail_ew(js, 1), theal.fail_ew(ts, 1)
    logits = _logits(3, 12, 8)
    logits[0] = 0.0                       # all eight experts tie
    logits[1, :] = 1.0
    logits[1, 6] = 2.0                    # one winner, then a 7-way tie
    for top_k in (2, 3, 5):
        jr, tr = _route_both(logits, js, ts, jp, tp, top_k=top_k)
        _assert_same(jr, tr)
    np.testing.assert_array_equal(tr["topk_idx"][0].numpy(), [0, 1, 2, 3, 4])


def test_grouped_dispatch_path():
    """Above ONEHOT_MAX_TOKENS tokens the dispatch is grouped with
    per-group capacity; the routing and expert_io agree with the
    reference."""
    jp, js, tp, ts = _states(4, 2, 2)
    t, d = 2 * trefe.ONEHOT_MAX_TOKENS + 512, 8
    logits = _logits(9, t, 4)
    jr, tr = _route_both(logits, js, ts, jp, tp, batch=4)
    assert tr["grouped"] and tr["groups"] > 1
    _assert_same(jr, tr)
    _check_expert_io(jr, tr, t, d, seed=1)


@pytest.mark.parametrize("case", ["healthy", "fail_ew0", "tight"])
def test_expert_io_matches_reference(case):
    jp, js, tp, ts = _states(8, 2, 2)
    if case == "fail_ew0":
        js, ts = jheal.fail_ew(js, 0), theal.fail_ew(ts, 0)
    logits = _logits(21, 24, 8)
    jr, tr = _route_both(logits, js, ts, jp, tp,
                         cf=0.5 if case == "tight" else 1.25)
    _check_expert_io(jr, tr, 24, 16, seed=2)
    # the one-hot tables the reference contracts
    jd, jc = jrefe.routing_onehots(jr)
    td, tc = trefe.routing_onehots(tr)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)


def _check_expert_io(jr, tr, t, d, seed):
    """A slot-dependent expert function, the same in both frameworks:
    y[p] = tanh(x[p] * (p + 1) / P)."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(t, d)).astype(np.float32)
    p = tr["num_slots"]

    def jfn(ein):
        scale = (jnp.arange(p) + 1.0).reshape((p,) + (1,) * (ein.ndim - 1))
        return jnp.tanh(ein * scale / p)

    def tfn(ein):
        scale = (torch.arange(p) + 1.0).reshape((p,) + (1,) * (ein.dim() - 1))
        return torch.tanh(ein * scale / p)

    want = jrefe.expert_io(jnp.asarray(x), jr, jfn)
    got = trefe.expert_io(torch.from_numpy(x), tr, tfn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_shadow_reroute_is_bitwise_in_the_port():
    """With EW0 failed its experts are served from shadow slots holding
    the same rows: the port's expert_io sums each token's choices in
    choice order, so the output is bitwise the failure-free one."""
    jp, js, tp, ts = _states(8, 2, 2)
    logits = _logits(4, 32, 8)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 16)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 16, 16)).astype(np.float32))

    def run(rs):
        r = trefe.route(x, torch.from_numpy(logits), rs, tp, top_k=2,
                        capacity_factor=2.0)
        idx = torch.clamp(rs.slot_expert.long(), min=0)
        return trefe.expert_io(x, r, lambda ein: torch.einsum(
            "pcd,pde->pce", ein, w[idx]))

    healthy = run(ts)
    failed = run(theal.fail_ew(ts, 0))
    assert torch.equal(healthy, failed)


def test_route_state_needs_a_device():
    """No CPU default: a caller names the device of the routing state."""
    tp = tert.default_placement(8, 2)
    with pytest.raises(TypeError):
        trefe.RouteState.healthy(tp, 2)
    with pytest.raises(TypeError):
        trefe.token_aw_owner(8, 2)
    rs = trefe.RouteState.healthy(tp, 2, device="cpu")
    assert rs.candidates.device.type == "cpu"
    assert trefe.token_aw_owner(8, 2, device="cpu").tolist() == \
        [0, 0, 0, 0, 1, 1, 1, 1]
