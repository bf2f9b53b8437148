"""The rest of the transformer family in the port (Qwen1.5-MoE-A2.7B,
Kimi-K2, Chameleon-34B, Granite-34B) against the JAX package on the CPU,
float32, reduced configs, fed the reference's params through
``repro_torch.convert``:

  * the configs match the reference field for field, full and reduced,
    ``param_count`` included; the port's own init draws the reference's
    leaf names and shapes at the same scales (Kimi's dense first layer,
    the shared experts of the MoE pair, Chameleon's q/k norms, Granite's
    ungated MLP), and its per-tensor cast gives the bits of a cast after
    the whole layer was drawn;
  * prefill, chunk and decode logits to 1e-4, healthy and with
    ``fail_ew(0)`` for the MoE pair, also at the two routing widths that
    ``reduced()`` hides (60 experts top-4 on 8 EWs: 64 stored rows and 80
    slots; 384 experts top-8 on 2 EWs: 768 slots);
  * one reduced prefill and decode step for every architecture the port
    lists (the twin of ``test_smoke_archs.py::test_prefill_decode_step``).

The engines' streams are in ``test_torch_families_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import selfheal as jheal
from repro.models import get_model as jget_model
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core import selfheal as theal
from repro_torch.models import get_model as tget_model
from repro_torch.models.transformer import cast_floats

ARCHS = ("qwen2_moe_a2_7b", "kimi_k2_1t_a32b", "chameleon_34b",
         "granite_34b")
MOE = ("qwen2_moe_a2_7b", "kimi_k2_1t_a32b")
TOL = dict(rtol=1e-4, atol=1e-4)


def _wide(cfg, experts, top_k):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=experts, top_k=top_k))


# (case, arch, (experts, top_k) or None for reduced(), num_ew)
LOGIT_CASES = [(a, a, None, 2) for a in ARCHS] + [
    ("qwen2_moe_60x4_ew8", "qwen2_moe_a2_7b", (60, 4), 8),
    ("kimi_k2_384x8_ew2", "kimi_k2_1t_a32b", (384, 8), 2)]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match(arch):
    j, t = jget_config(arch), tget_config(arch)
    for cj, ct in ((j, t), (j.reduced(), t.reduced())):
        for f in dataclasses.fields(ct):
            if f.name in ("moe", "ssm"):
                assert getattr(ct, f.name).__dict__ == \
                    getattr(cj, f.name).__dict__, f.name
            else:
                assert getattr(ct, f.name) == getattr(cj, f.name), f.name
        assert ct.head_dim_ == cj.head_dim_
        assert ct.param_count == cj.param_count
    assert (t.head_dim_, t.num_heads // t.num_kv_heads) == \
        {"qwen2_moe_a2_7b": (128, 1), "kimi_k2_1t_a32b": (112, 8),
         "chameleon_34b": (128, 8), "granite_34b": (128, 48)}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_draws_the_reference_leaves(arch):
    """Against the reference's params (its model's ``init_params`` on the
    reduced config at 2 EWs)."""
    tcfg = tget_config(arch).reduced()
    jp = jget_model(jget_config(arch).reduced(), num_aw=2,
                    num_ew=2).init_params(jax.random.PRNGKey(0))
    ref = params_from_reference(jp, device="cpu")
    own = tget_model(tcfg, num_aw=2, num_ew=2, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert _shapes(own) == _shapes(ref)
    assert ("dense0" in jp) == (arch == "kimi_k2_1t_a32b")
    first, last = own["layers"][0], own["layers"][-1]
    assert ("mlp" in first) == (arch != "qwen2_moe_a2_7b")
    if arch in MOE:
        assert "shared" in last["moe"]
    attn = first["attn"]
    assert ("q_norm" in attn) == ("k_norm" in attn) == \
        (arch == "chameleon_34b")
    assert ("bq" in attn) == (arch == "qwen2_moe_a2_7b")
    ffn = last["moe"] if arch in MOE else last["mlp"]
    if arch not in MOE:
        assert ("w_gate" in ffn) == (arch != "granite_34b")
    # the same scales: every drawn leaf's std within 15% of the reference's
    pairs = [(own["embed"], ref["embed"]),
             (attn["wq"], ref["layers"][0]["attn"]["wq"]),
             (attn["wo"], ref["layers"][0]["attn"]["wo"])]
    if arch in MOE:
        for name in ("wg", "wd"):
            pairs.append((ffn["experts"][name],
                          ref["layers"][-1]["moe"]["experts"][name]))
        pairs.append((ffn["shared"]["w_down"],
                      ref["layers"][-1]["moe"]["shared"]["w_down"]))
    else:
        pairs.append((ffn["w_up"], ref["layers"][-1]["mlp"]["w_up"]))
    for a, b in pairs:
        assert abs(a.std().item() / b.std().item() - 1) < 0.15


@pytest.mark.parametrize("arch", MOE)
def test_per_tensor_cast_keeps_the_bits(arch):
    """At a reduced bf16 config, the init that casts each tensor as it is
    drawn gives bitwise the weights of drawing the whole model in float32
    and casting after: the draws, their order and their scales did not
    move, only the peak memory."""
    tcfg = tget_config(arch).reduced()
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    got = tget_model(bf, num_aw=2, num_ew=2, device="cpu").init_params(
        torch.Generator().manual_seed(5))
    f32 = tget_model(tcfg, num_aw=2, num_ew=2, device="cpu").init_params(
        torch.Generator().manual_seed(5))
    want = cast_floats(f32, torch.bfloat16)
    assert _shapes(got) == _shapes(want)

    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k])
        elif isinstance(tree, list):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype == torch.bfloat16 or \
            not a.is_floating_point()
        assert torch.equal(a, b)


def _random_biases(params, seed):
    """The reference's params with every QKV bias drawn at random (the
    init draws zeros, which would leave the bias path untested)."""
    r = np.random.default_rng(seed)

    def draw(path, leaf):
        if getattr(path[-1], "key", None) in ("bq", "bk", "bv"):
            return jnp.asarray(r.normal(size=leaf.shape).astype(np.float32)
                               * 0.5)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, params)


def _pairs(jcache, tcache):
    """(JAX layer cache, port layer cache) of every layer, in stack
    order."""
    j = [jcache[k] for k in sorted(jcache) if k.startswith("dense")]
    out = [({n: np.asarray(v) for n, v in c.items()}, t)
           for c, t in zip(j, tcache["layers"])]
    blocks = jcache["blocks"][0]
    for i, t in enumerate(tcache["layers"][len(j):]):
        out.append(({n: np.asarray(v[i]) for n, v in blocks.items()}, t))
    return out


@pytest.mark.parametrize("case,arch,wide,num_ew", LOGIT_CASES,
                         ids=[c[0] for c in LOGIT_CASES])
def test_prefill_chunk_and_decode_logits(case, arch, wide, num_ew):
    """Whole-prompt prefill, then three decode steps; a second cache
    filled by two chunk calls, then the same decode steps; logits to 1e-4
    and the caches they write. The MoE pair also with EW0 failed (its
    experts served from the shadow slots)."""
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    if wide is not None:
        jcfg, tcfg = _wide(jcfg, *wide), _wide(tcfg, *wide)
    japi = jget_model(jcfg, num_aw=2, num_ew=num_ew)
    tapi = tget_model(tcfg, num_aw=2, num_ew=num_ew, device="cpu")
    if wide is not None:
        assert tapi.placement.num_slots == {(60, 4): 80,
                                            (384, 8): 768}[wide]
        assert tapi.placement.primary_slots == {(60, 4): 64,
                                                (384, 8): 384}[wide]
    jp = _random_biases(japi.init_params(jax.random.PRNGKey(0)), 1)
    tp = params_from_reference(jp, device="cpu")
    jpre = jax.jit(japi.prefill, static_argnames=("max_seq", "capacity"))
    jchunk = jax.jit(japi.prefill_chunk, static_argnames=("capacity",))
    jdec = jax.jit(japi.decode, static_argnames=("capacity",))
    fails = [None, 0] if tcfg.moe.enabled else [None]
    r = np.random.default_rng(3)
    b, s, max_seq = 2, 12, 24
    toks = r.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    steps = r.integers(0, jcfg.vocab_size, (3, b)).astype(np.int32)
    for fail in fails:
        jrs, trs = japi.init_route_state(), tapi.init_route_state()
        if fail is not None:
            jrs, trs = jheal.fail_ew(jrs, fail), theal.fail_ew(trs, fail)
        jl, jc = jpre(jp, {"tokens": jnp.asarray(toks)}, jrs,
                      max_seq=max_seq, capacity=64)
        tl, tc, _ = tapi.prefill(tp, torch.from_numpy(toks), trs, max_seq,
                                 capacity=64)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        # the same prompt in two chunks (7 + 5 tokens, the second chunk
        # padded to 7 with -1 positions)
        jcc, tcc = japi.init_cache(b, max_seq), tapi.init_cache(b, max_seq)
        for lo, hi in ((0, 7), (7, 12)):
            ct = np.zeros((b, 7), np.int32)
            cp = np.full((b, 7), -1, np.int32)
            ct[:, :hi - lo] = toks[:, lo:hi]
            cp[:, :hi - lo] = np.arange(lo, hi)
            jcc = jchunk(jp, jnp.asarray(ct), jnp.asarray(cp), jcc, jrs,
                         capacity=64)
            tcc, _ = tapi.prefill_chunk(tp, torch.from_numpy(ct),
                                        torch.from_numpy(cp), tcc, trs,
                                        capacity=64)
        pos = np.full((b,), s, np.int32)
        for nt in steps:
            jl, jc = jdec(jp, jnp.asarray(nt), jnp.asarray(pos), jc, jrs)
            tl, tc, _ = tapi.decode(tp, torch.from_numpy(nt),
                                    torch.from_numpy(pos), tc, trs)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            jlc, jcc = jdec(jp, jnp.asarray(nt), jnp.asarray(pos), jcc, jrs)
            tlc, tcc, _ = tapi.decode(tp, torch.from_numpy(nt),
                                      torch.from_numpy(pos), tcc, trs)
            np.testing.assert_allclose(tlc.numpy(), np.asarray(jlc), **TOL)
            pos = pos + 1
        for jcache, tcache in ((jc, tc), (jcc, tcc)):
            for jlayer, tlayer in _pairs(jcache, tcache):
                np.testing.assert_array_equal(tlayer["pos"].numpy(),
                                              jlayer["pos"])
                np.testing.assert_allclose(tlayer["k"].numpy(), jlayer["k"],
                                           **TOL)
                np.testing.assert_allclose(tlayer["v"].numpy(), jlayer["v"],
                                           **TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_step(arch):
    """One reduced prefill and one decode step of every architecture the
    port lists: shapes, no NaN, the cache structure preserved (the twin of
    the reference's ``test_prefill_decode_step``). ``forward_train`` and
    the train-step tests wait for the port's training slice."""
    cfg = tget_config(arch).reduced()
    api = tget_model(cfg, num_aw=2, num_ew=2, device="cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    rs = api.init_route_state()
    b, s = 2, 12
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))
    kw = {}
    if cfg.is_encdec:
        kw["frames"] = torch.from_numpy(rng.normal(size=(
            b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    last, cache, _ = api.prefill(params, toks, rs, s + 8, **kw)
    assert last.shape == (b, cfg.vocab_size)
    structure = _shapes(cache)
    tok = last.argmax(-1).to(torch.int32)
    pos = torch.full((b,), s, dtype=torch.int32)
    logits, cache2, _ = api.decode(params, tok, pos, cache, rs)
    assert logits.shape == (b, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    assert _shapes(cache2) == structure
