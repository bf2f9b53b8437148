"""The port's launch plane against the JAX package's: the shape and arch
helpers of ``configs``, the ``Sharder``'s specs for every leaf of all 11
architectures at full width (port leaves on the ``meta`` device, the
reference's from ``jax.eval_shape``) at both production meshes and 1x1
under three policies, the cache and batch rules, the rule tests of
``tests/test_sharding.py`` on the port's paths, DTensor placements on
torch's fake process group at 256 and 512 ranks, and the sharded decode
on a 1x1 mesh over a 1-rank gloo group."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import all_configs as j_all_configs
from repro.configs import get_config as jget_config
from repro.configs.base import LONG_CONTEXT_ARCHS as J_LONG
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import supports_shape as j_supports
from repro.launch.mesh import make_debug_mesh as j_debug_mesh
from repro.launch.sharding import Sharder as JSharder
from repro.launch.sharding import ShardingPolicy as JPolicy
from repro.models import get_model as jget_model
from repro.serving.kvcache import CacheLayout as JCacheLayout
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import (ARCH_IDS, ASSIGNED_ARCHS, LONG_CONTEXT_ARCHS,
                                 SHAPES, all_configs, get_config,
                                 supports_shape)
from repro_torch.convert import params_from_reference
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.sharding import Sharder, ShardingPolicy, local_shards
from repro_torch.models.registry import get_model
from repro_torch.training.train import leaf_paths

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 1, "model": 1})
POLICIES = ({}, {"expert_ff_over_data": True}, {"zero_over_pod": True})


# ----------------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------------
def test_shapes_and_arch_helpers_equal_reference():
    assert SHAPES == {k: type(SHAPES[k])(**vars(v))
                      for k, v in J_SHAPES.items()}
    assert LONG_CONTEXT_ARCHS == J_LONG
    assert ASSIGNED_ARCHS == J_ASSIGNED
    for inc in (True, False):
        assert list(all_configs(inc)) == list(j_all_configs(inc))
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert supports_shape(get_config(arch), SHAPES[name]) == \
                j_supports(jget_config(arch), J_SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_reference(arch):
    t, j = get_config(arch), jget_config(arch)
    assert t.param_count == j.param_count
    assert t.active_param_count == j.active_param_count


# ----------------------------------------------------------------------------
# sharding parity
# ----------------------------------------------------------------------------
class FakeMesh:
    """Just enough mesh for the reference Sharder's rule checks."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def ref_sharder(cfg, sizes, policy):
    sh = JSharder.__new__(JSharder)
    sh.cfg = cfg
    sh.mesh = FakeMesh(sizes)
    sh.policy = policy
    dp = tuple(a for a in sizes if a in ("pod", "data"))
    sh.dp = dp[0] if len(dp) == 1 else dp
    sh.mp = "model"
    sh.mp_size = sizes["model"]
    sh.dp_size = int(np.prod([sizes[a] for a in dp]))
    sh.data_size = sizes["data"]
    return sh


def ref_path(cfg, path):
    """The reference's path of a port leaf (``convert.py`` read back)."""
    m = re.match(r"^(layers|blocks|enc|dec)/(\d+)/(.*)$", path)
    if m is None:
        return path
    root, i, rest = m.group(1), int(m.group(2)), m.group(3)
    if root in ("enc", "dec"):
        return f"{root}/{rest}"
    if cfg.xlstm_pattern:
        return f"blocks/{i % len(cfg.xlstm_pattern)}/{rest}"
    if cfg.ssm.enabled and cfg.hybrid_attn_every:
        units = cfg.num_layers // cfg.hybrid_attn_every
        return f"units/{rest}" if i < units * cfg.hybrid_attn_every \
            else f"trailing/{rest}"
    first = cfg.moe.first_k_dense if cfg.moe.enabled else 0
    if i < first:
        return f"dense{i}/{rest}"
    return f"blocks/{(i - first) % len(cfg.attn_pattern)}/{rest}"


def _ref_shapes(cfg, sizes):
    api = jget_model(cfg, num_aw=sizes["data"], num_ew=sizes["model"])
    ps = jax.eval_shape(api.init_params,
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    flat, _ = jax.tree_util.tree_flatten_with_path(ps)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): tuple(leaf.shape) for p, leaf in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch):
    """Every port leaf gets its reference leaf's spec with the layer axes
    dropped, at data 16 x model 16, pod 2 x data 16 x model 16 and 1 x 1,
    under the default, ``expert_ff_over_data`` and ``zero_over_pod``
    policies."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for sizes in MESHES:
        ref = _ref_shapes(jcfg, sizes)
        params = get_model(cfg, num_aw=sizes["data"], num_ew=sizes["model"],
                           device="meta").init_params(torch.Generator())
        shapes = {p: tuple(t.shape) for p, t in leaf_paths(params).items()}
        for pol in POLICIES:
            ours = Sharder(cfg, sizes, ShardingPolicy(**pol))
            theirs = ref_sharder(jcfg, sizes, JPolicy(**pol))
            specs = ours.param_specs(params)
            for path, spec in specs.items():
                stack = ours.layer_stack(path)
                rshape = ref[ref_path(cfg, path)]
                assert rshape[len(stack):] == shapes[path], path
                want = tuple(theirs.param_spec(ref_path(cfg, path),
                                               rshape))[len(stack):]
                assert spec == want, (sizes, pol, path, spec, want)


# a port cache's state leaf [B, L, ...] -> the reference's leaves of it
REF_STATE = {"h": ("units/h", "trailing/h"),
             "conv": ("units/conv", "trailing/conv"),
             "mlstm_c": ("0/c",), "mlstm_n": ("0/n",), "mlstm_m": ("0/m",),
             "slstm_c": ("1/c",), "slstm_n": ("1/n",), "slstm_m": ("1/m",),
             "slstm_h": ("1/h",), "cross_k": ("cross/k",),
             "cross_v": ("cross/v",)}


def ref_cache_path(cfg, path):
    """The reference's leaf of a port cache's attention leaf."""
    i, leaf = int(path.split("/")[1]), path.rsplit("/", 1)[-1]
    if cfg.is_encdec or (cfg.ssm.enabled and cfg.hybrid_attn_every):
        return f"kv/{leaf}"
    return ref_path(cfg, f"layers/{i}/{leaf}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_reference(arch):
    """Every leaf of the port's decode caches at decode_32k and long_500k
    gets its reference leaf's spec (from the reference's stacked cache,
    its layer axes dropped), and ``cache_spec`` and ``batch_spec`` equal
    the reference's on the same inputs."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    api = get_model(cfg, num_aw=2, num_ew=2, device="meta")
    japi = jget_model(jcfg, num_aw=2, num_ew=2)
    layout = JCacheLayout(japi.init_cache)
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        b, s = shape.global_batch, shape.seq_len
        cache = api.init_cache(b, s)
        jc = jax.tree_util.tree_leaves(
            jax.eval_shape(lambda: japi.init_cache(b, s)))
        ref = {p: (tuple(leaf.shape), ax, kind) for p, leaf, ax, kind in
               zip(layout.paths, jc, layout.batch_axis, layout.leaf_kind)}
        for sizes in MESHES:
            ours = Sharder(cfg, sizes)
            theirs = ref_sharder(jcfg, sizes, JPolicy())

            def ref_spec(rp):
                """The reference leaf's spec from its batch axis on, and
                the port's cache_spec on the same inputs equal to it."""
                rshape, ax, kind = ref[rp]
                spec = tuple(theirs.cache_spec(kind, rshape, ax))
                assert ours.cache_spec(kind, rshape, ax) == spec
                return spec[ax:]
            for path, spec in ours.cache_specs(cache).items():
                if path in REF_STATE:
                    # batch first, the layer axis left out
                    for rp in REF_STATE[path]:
                        assert spec[:1] + spec[2:] == ref_spec(rp), \
                            (sizes, path, rp)
                else:
                    assert spec == ref_spec(ref_cache_path(cfg, path)), \
                        (sizes, path, spec)
    for sizes in MESHES:
        ours = Sharder(cfg, sizes)
        theirs = ref_sharder(jcfg, sizes, JPolicy())
        for shape in SHAPES.values():
            for dims in ((shape.global_batch, shape.seq_len),
                         (shape.global_batch,), ()):
                assert ours.batch_spec(dims) == \
                    tuple(theirs.batch_spec(dims))


# the rule tests of tests/test_sharding.py, on the port's paths (one
# layer's leaf: the reference's spec with the layer axis dropped)
def specs_for(arch, sizes, policy=ShardingPolicy()):
    return Sharder(get_config(arch), sizes, policy)


def test_param_rules_dense():
    sh = specs_for("qwen2_1_5b", {"data": 16, "model": 16})
    assert sh.param_spec("layers/0/attn/wq", (1536, 1536)) == \
        (None, "model")
    assert sh.param_spec("layers/0/attn/wo", (1536, 1536)) == \
        ("model", None)
    assert sh.param_spec("layers/0/mlp/w_up", (1536, 8960)) == \
        (None, "model")
    assert sh.param_spec("embed", (151936, 1536)) == ("model", None)
    assert sh.param_spec("layers/0/ln1/scale", (1536,)) == (None,)


def test_param_rules_moe_and_divisibility_guard():
    sh = specs_for("kimi_k2_1t_a32b", {"data": 16, "model": 16},
                   ShardingPolicy(expert_ff_over_data=True))
    assert sh.param_spec("layers/1/moe/experts/wu", (384, 7168, 2048)) \
        == ("model", None, "data")
    assert sh.param_spec("layers/1/moe/experts/wd", (384, 2048, 7168)) \
        == ("model", "data", None)
    # 26 shadow slots don't divide 16 -> expert axis replicated
    assert sh.param_spec("layers/1/moe/shadow/wu", (26, 7168, 2048)) \
        == (None, None, "data")
    # 32 slots divide -> sharded
    assert sh.param_spec("layers/1/moe/shadow/wu", (32, 7168, 2048)) \
        == ("model", None, "data")


def test_cache_rules():
    sh = specs_for("qwen2_1_5b", {"data": 16, "model": 16})
    # Hkv=2 doesn't divide 16 -> fall back to sequence sharding
    assert sh.cache_spec("attn_k", (14, 128, 32768, 2, 128), 1) == \
        (None, "data", "model", None, None)
    # Hkv=32 divides -> heads sharded
    assert sh.cache_spec("attn_k", (14, 128, 32768, 32, 112), 1) == \
        (None, "data", None, "model", None)
    # batch=1 (long_500k): batch unsharded, seq over model
    assert sh.cache_spec("attn_k", (14, 1, 524288, 2, 128), 1) == \
        (None, None, "model", None, None)
    # a port layer's leaf, judged with its stack of 28 layers in front
    specs = sh.cache_specs({"layers": [{
        "k": torch.empty((128, 32768, 2, 128), device="meta"),
        "pos": torch.empty((128, 32768), device="meta")}]})
    assert specs["layers/0/k"] == ("data", "model", None, None)
    assert specs["layers/0/pos"] == ("data", None)


def test_batch_rules_multi_pod():
    sh = specs_for("qwen2_1_5b", {"pod": 2, "data": 16, "model": 16})
    assert sh.batch_spec((256, 4096)) == (("pod", "data"), None)
    assert sh.batch_spec((32, 32768)) == (("pod", "data"), None)
    assert sh.batch_spec((1, 524288)) == (None, None)


def test_zero_over_pod_follows_the_reference_stacking():
    """ZeRO puts ``pod`` on the largest free dim of the reference's
    stacked leaf: for a Zamba2 unit block's ``conv_w`` that is the unit's
    block axis (6), which the port's leaf does not have; for a trailing
    block it is the conv width (4)."""
    sh = specs_for("zamba2_7b", {"pod": 2, "data": 16, "model": 16},
                   ShardingPolicy(zero_over_pod=True))
    assert sh.layer_stack("blocks/0/mamba/conv_w") == (13, 6)
    assert sh.layer_stack("blocks/80/mamba/conv_w") == (3,)
    assert sh.param_spec("blocks/0/mamba/conv_w", (4, 7168),
                         (13, 6)) == (None, "model")
    assert sh.param_spec("blocks/80/mamba/conv_w", (4, 7168),
                         (3,)) == ("pod", "model")


# ----------------------------------------------------------------------------
# placements on the fake process group
# ----------------------------------------------------------------------------
@pytest.fixture(params=[False, True], ids=["256", "512"])
def production_mesh(request):
    with tmesh.fake_group(512 if request.param else 256):
        yield tmesh.make_production_mesh(multi_pod=request.param)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_split_evenly_on_the_fake_group(production_mesh, arch):
    """Each DTensor's rank-0 shard is the leaf's shape divided by the
    sizes of the axes that split it, params and decode cache."""
    sizes = tmesh.axis_sizes(production_mesh)
    assert production_mesh.device_type == "cuda"
    cfg = get_config(arch)
    api = get_model(cfg, num_aw=sizes["data"], num_ew=sizes["model"],
                    device="meta")
    params = api.init_params(torch.Generator())
    sh = Sharder(cfg, production_mesh,
                 ShardingPolicy(zero_over_pod="pod" in sizes))
    specs = sh.param_specs(params)
    shapes = {p: tuple(t.shape) for p, t in leaf_paths(params).items()}
    placed = leaf_paths(sh.shard_params(params))
    cache = api.init_cache(128, 32768)
    cspecs = sh.cache_specs(cache)
    cshapes = {p: tuple(t.shape) for p, t in leaf_paths(cache).items()}
    cplaced = leaf_paths(sh.shard_cache(cache))
    tokens = sh.shard_batch({"tokens": torch.empty((128, 32768),
                                                   device="meta")})
    dp = 32 if "pod" in sizes else 16
    assert tuple(tokens["tokens"].to_local().shape) == (128 // dp, 32768)
    rs = sh.replicated(api.init_route_state())
    assert all(tuple(d.to_local().shape) == tuple(d.shape)
               for d in leaf_paths(rs).values())
    for got, sp, shp in ((placed, specs, shapes),
                         (cplaced, cspecs, cshapes)):
        for path, d in got.items():
            want = list(shp[path])
            for i, e in enumerate(sp[path]):
                for a in (e if isinstance(e, tuple) else (e,)):
                    if a is not None:
                        want[i] //= sizes[a]
            assert tuple(d.to_local().shape) == tuple(want), path
            assert tuple(d.shape) == shp[path]


def test_a_mesh_needs_a_group_and_a_process_has_one():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh()
    with tmesh.fake_group(256):
        with pytest.raises(RuntimeError, match="needs 512 ranks"):
            tmesh.make_production_mesh(multi_pod=True)
        with pytest.raises(RuntimeError, match="already up"):
            with tmesh.single_rank_group("cpu"):
                pass
    assert not dist.is_initialized()


def test_meta_and_dtensor_inputs_reach_no_kernel():
    q = torch.empty((2, 4, 32), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        ops.decode_attention(q, q, q, q, q, q, q)
    with tmesh.single_rank_group("cpu"):
        m = tmesh.make_debug_mesh(device_type="cpu")
        d = Sharder(get_config("mixtral_8x7b").reduced(), m).place(
            torch.zeros((2, 4, 32)), (None, None, None))
        with pytest.raises(TypeError, match="DTensor"):
            ops.decode_attention(d, d, d, d, d, d, d)


# ----------------------------------------------------------------------------
# the sharded decode on one device
# ----------------------------------------------------------------------------
def test_sharded_decode_runs_on_one_device():
    """Reduced Mixtral at capacity factor 4.0 on a 1x1 mesh over a 1-rank
    gloo group: the decode step on the Sharder's local shards gives the
    unsharded port's logits bitwise, and the reference's sharded decode
    (jit with explicit shardings on its 1x1 mesh) within 1e-4."""
    import dataclasses
    jcfg = jget_config("mixtral_8x7b").reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=4.0))
    cfg = get_config("mixtral_8x7b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    japi = jget_model(jcfg, num_aw=1, num_ew=1)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    jrs = japi.init_route_state()
    jmesh = j_debug_mesh((1, 1), ("data", "model"))
    jsharder = JSharder(jcfg, jmesh)
    layout = JCacheLayout(japi.init_cache)
    jcache = japi.init_cache(2, 16)
    with jmesh:
        fn = jax.jit(japi.decode, in_shardings=(
            jsharder.shard_params(jparams), jsharder.named(JP()),
            jsharder.named(JP()), jsharder.shard_cache(layout, jcache),
            jsharder.replicated(jrs)))
        jlogits, _ = fn(jparams, jnp.zeros((2,), jnp.int32),
                        jnp.full((2,), 3, jnp.int32), jcache, jrs)

    api = get_model(cfg, num_aw=1, num_ew=1, device="cpu")
    params = params_from_reference(jparams, device="cpu")
    tokens = torch.zeros((2,), dtype=torch.int32)
    pos = torch.full((2,), 3, dtype=torch.int32)
    want, _, _ = api.decode(params, tokens, pos, api.init_cache(2, 16),
                            api.init_route_state())
    with tmesh.single_rank_group("cpu"):
        mesh = tmesh.make_debug_mesh(device_type="cpu")
        sh = Sharder(cfg, mesh)
        sharded = sh.shard_params(params_from_reference(jparams,
                                                        device="cpu"))
        cache = sh.shard_cache(api.init_cache(2, 16))
        rs = sh.replicated(api.init_route_state())
        got, _, _ = api.decode(local_shards(sharded), tokens, pos,
                               local_shards(cache), local_shards(rs))
    assert got.shape == (2, cfg.vocab_size)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), atol=1e-4,
                               rtol=1e-4)
