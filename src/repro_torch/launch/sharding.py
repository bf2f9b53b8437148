"""Sharding rules: map every param / cache / batch leaf of the port's trees
to a spec on the production mesh, and place the leaves as DTensors (port
of ``repro.launch.sharding``).

Baseline (paper-faithful MegaScale/DEP mapping):
  * attention params  — tensor-parallel over ``model`` (heads / d_ff split),
    batch over ``pod``+``data``  (AW group = data-parallel attention)
  * MoE expert banks  — expert axis over ``model`` (EW group = expert
    parallel); optionally the per-expert FF dim over ``data`` for weights
    that exceed HBM otherwise (kimi-k2)
  * KV caches         — batch over dp; KV heads over ``model`` when they
    divide, else the sequence axis (long_500k / few-KV-head archs)

Everything is divisibility-guarded: a dim is only sharded if the axis size
divides it. ``ShardingPolicy`` carries the per-arch overrides.

A spec has one entry per tensor dim: None, an axis name, or a tuple of
names (major first), as a JAX ``PartitionSpec``. The rules read only the
mesh's axis names and sizes (a ``DeviceMesh`` or a dict of them), so they
need no process group.

The port's params hold one dict per layer where the reference stacks the
layers on leading axes. The rules anchor on the tail of a path and count
dims from the end, so a layer's leaf gets its reference leaf's spec with
the layer axes dropped; ``layer_stack`` gives those axes (the reference's
stacking, ``convert.py``'s map read backwards), because ZeRO over ``pod``
picks the largest free dim of the stacked leaf, a layer axis included.

Placing: ``shard_params`` and the other walkers turn each leaf into a
DTensor on the mesh, leaf by leaf, dropping the source as they go (on a
1-device mesh the DTensor wraps the leaf itself: no copy). Kernels never
see a DTensor: a server runs on ``local_shards(tree)``.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Tuple

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes, dp_axes
from repro_torch.serving.kvcache import state_leaves
from repro_torch.training.train import leaf_paths


@dataclass(frozen=True)
class ShardingPolicy:
    expert_ff_over_data: bool = False    # kimi-k2: shard expert FF over data
    vocab_over_model: bool = True
    seq_shard_long: bool = True          # batch-1 decode: shard KV seq
    # ZeRO-style weight sharding over the pod axis (train memory relief)
    zero_over_pod: bool = False
    # only seq-shard a KV cache when replicating it would cost memory: a
    # ring-buffered sliding-window cache is small
    cache_replicate_max_bytes: int = 256 * 2**20


def _div(n: int, size: int) -> bool:
    return size > 1 and n % size == 0 and n >= size


_LAYER_RE = re.compile(r"^(layers|blocks|enc|dec)/(\d+)/")


class Sharder:
    def __init__(self, cfg: ModelConfig, mesh,
                 policy: ShardingPolicy = ShardingPolicy()):
        self.cfg = cfg
        self.mesh = mesh
        self.policy = policy
        self.sizes = axis_sizes(mesh)
        dp = dp_axes(mesh)
        self.dp = dp[0] if len(dp) == 1 else dp
        self.mp = "model"
        self.mp_size = self.sizes["model"]
        self.dp_size = self.axis_size(self.dp)
        self.data_size = self.sizes["data"]

    def axis_size(self, name) -> int:
        """The devices along an axis name or a tuple of them."""
        if isinstance(name, tuple):
            return math.prod(self.sizes[a] for a in name)
        return self.sizes[name]

    @staticmethod
    def _spec_nd(ndim: int, placed: Dict[int, Any]) -> Tuple:
        dims = [None] * ndim
        for ax, name in placed.items():
            dims[ax] = name
        return tuple(dims)

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def layer_stack(self, path: str) -> Tuple[int, ...]:
        """The leading axes the reference stacks this leaf's layer on (()
        for a leaf outside the layer stacks and for a dense first layer)."""
        m = _LAYER_RE.match(path)
        if m is None:
            return ()
        cfg, root, i = self.cfg, m.group(1), int(m.group(2))
        if root == "enc":
            return (cfg.encoder_layers,)
        if root == "dec":
            return (cfg.num_layers,)
        if cfg.xlstm_pattern:
            return (cfg.num_layers // len(cfg.xlstm_pattern),)
        if cfg.ssm.enabled and cfg.hybrid_attn_every:
            every = cfg.hybrid_attn_every
            units = cfg.num_layers // every
            return (units, every) if i < units * every else \
                (cfg.num_layers % every,)
        first = cfg.moe.first_k_dense if cfg.moe.enabled else 0
        if i < first:
            return ()
        return ((cfg.num_layers - first) // len(cfg.attn_pattern),)

    def param_spec(self, path: str, shape, stack: Tuple[int, ...] = ()
                   ) -> Tuple:
        """Spec of a leaf at ``path``; ``stack`` names the reference's
        layer axes in front of ``shape``, which the result leaves out."""
        shape = tuple(stack) + tuple(shape)
        nd = len(shape)
        mp, dp = self.mp, "data"
        pol = self.policy

        def last_over_mp():
            return {nd - 1: mp} if _div(shape[-1], self.mp_size) else {}

        def penult_over_mp():
            return {nd - 2: mp} if _div(shape[-2], self.mp_size) else {}

        placed: Dict[int, Any] = {}
        if re.search(r"(experts|shadow)/(wg|wu)$", path):
            # [..., E, D, F]
            if _div(shape[nd - 3], self.mp_size):
                placed[nd - 3] = mp
            if pol.expert_ff_over_data and _div(shape[-1], self.data_size):
                placed[nd - 1] = dp
        elif re.search(r"(experts|shadow)/wd$", path):
            # [..., E, F, D]
            if _div(shape[nd - 3], self.mp_size):
                placed[nd - 3] = mp
            if pol.expert_ff_over_data and _div(shape[-2], self.data_size):
                placed[nd - 2] = dp
        elif re.search(r"router$", path):
            placed = {}
        elif re.search(r"(embed|unembed)$", path):
            if pol.vocab_over_model and _div(shape[-2], self.mp_size):
                placed[nd - 2] = mp
        elif re.search(r"/(wq|wk|wv|w_up|w_gate|in_proj|wi|wf|wz|wo_gate|"
                       r"ri|rf|rz|ro)$", path):
            placed = last_over_mp()
        elif re.search(r"/(wo|w_down|out_proj)$", path):
            placed = penult_over_mp()
        elif re.search(r"/(bq|bk|bv)$", path):
            placed = last_over_mp()
        elif re.search(r"/conv_w$", path):
            placed = last_over_mp()

        if pol.zero_over_pod and "pod" in self.sizes:
            # FSDP/ZeRO: additionally shard the largest unplaced dim over pod
            pod = self.sizes["pod"]
            free = [i for i in range(nd) if i not in placed]
            free.sort(key=lambda i: -shape[i])
            for i in free:
                if _div(shape[i], pod):
                    placed[i] = "pod"
                    break
        return self._spec_nd(nd, placed)[len(stack):]

    def param_specs(self, params) -> Dict[str, Tuple]:
        """path -> spec of every leaf of the port's param tree."""
        return {p: self.param_spec(p, t.shape, self.layer_stack(p))
                for p, t in leaf_paths(params).items()}

    # ------------------------------------------------------------------
    # cache
    # ------------------------------------------------------------------
    def cache_spec(self, kind: str, shape, batch_axis: int) -> Tuple:
        nd = len(shape)
        placed: Dict[int, Any] = {}
        b = shape[batch_axis]
        if _div(b, self.dp_size):
            placed[batch_axis] = self.dp
        elif _div(b, self.data_size):
            placed[batch_axis] = "data"
        if kind in ("attn_k", "attn_v"):
            h_ax, s_ax = batch_axis + 2, batch_axis + 1
            leaf_bytes = 2 * math.prod(shape)   # bf16
            if batch_axis in placed:
                leaf_bytes //= self.dp_size
            if _div(shape[h_ax], self.mp_size):
                placed[h_ax] = self.mp
            elif self.policy.seq_shard_long and _div(shape[s_ax],
                                                     self.mp_size) and \
                    leaf_bytes > self.policy.cache_replicate_max_bytes:
                placed[s_ax] = self.mp
        elif kind == "state":
            # shard the first post-batch dim divisible by model axis
            for ax in range(batch_axis + 1, nd):
                if _div(shape[ax], self.mp_size):
                    placed[ax] = self.mp
                    break
        return self._spec_nd(nd, placed)

    def cache_specs(self, cache) -> Dict[str, Tuple]:
        """path -> spec of every leaf of a contiguous cache of the port
        (the slot is axis 0 of every leaf), as the reference's stacked
        cache gets it: an attention leaf ``layers/i/{k,v,pos}`` is
        judged with its layer stack in front (the seq-shard threshold
        weighs the whole stack's bytes), a state leaf [B, L, ...] with
        its layer axis left out."""
        states = set(state_leaves(cache))
        out = {}
        for p, t in leaf_paths(cache).items():
            shape = tuple(t.shape)
            if p in states:
                spec = self.cache_spec("state", shape[:1] + shape[2:], 0)
                out[p] = spec[:1] + (None,) + spec[1:]
                continue
            stack = self.cache_stack(p)
            kind = "attn_" + p.rsplit("/", 1)[-1]
            out[p] = self.cache_spec(kind, stack + shape,
                                     len(stack))[len(stack):]
        return out

    def cache_stack(self, path: str) -> Tuple[int, ...]:
        """The reference's stacking of the attention cache of layer
        ``layers/i``: the unit's repeats (a dense first layer: none), the
        hybrid's shared-block applications, Whisper's decoder layers."""
        cfg, i = self.cfg, int(path.split("/")[1])
        if cfg.is_encdec:
            return (cfg.num_layers,)
        if cfg.ssm.enabled and cfg.hybrid_attn_every:
            return (cfg.num_layers // cfg.hybrid_attn_every,)
        return self.layer_stack(f"layers/{i}/")

    # ------------------------------------------------------------------
    # activations / batch inputs
    # ------------------------------------------------------------------
    def batch_spec(self, shape) -> Tuple:
        nd = len(shape)
        if nd == 0:
            return ()
        if _div(shape[0], self.dp_size):
            return self._spec_nd(nd, {0: self.dp})
        if _div(shape[0], self.data_size):
            return self._spec_nd(nd, {0: "data"})
        return self._spec_nd(nd, {})

    # ------------------------------------------------------------------
    # placing
    # ------------------------------------------------------------------
    def placements(self, spec) -> list:
        """One DTensor placement per mesh axis: ``Shard(d)`` where tensor
        dim d is split over the axis (a dim over ("pod", "data") is
        ``Shard(d)`` on both, major first), else ``Replicate()``."""
        out = []
        for axis in self.sizes:
            dims = [d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def local_shape(self, shape, spec) -> Tuple[int, ...]:
        """The shape of one device's shard (the rules only split evenly)."""
        return tuple(
            s if e is None else s // self.axis_size(e)
            for s, e in zip(shape, spec))

    def place(self, t, spec):
        """``t`` as a DTensor on the mesh with ``spec``'s placements: on a
        1-device mesh the DTensor wraps ``t`` itself, else
        ``distribute_tensor`` makes each rank's shard."""
        placements = self.placements(spec)
        if self.mesh.size() == 1:
            return DTensor.from_local(t, self.mesh, placements,
                                      run_check=False)
        return distribute_tensor(t, self.mesh, placements)

    def shard_params(self, params):
        """Every leaf placed by ``param_spec``, in place (dicts and lists
        are updated leaf by leaf, so each source is dropped as soon as its
        DTensor exists); returns the tree."""
        return _walk(params, lambda p, t: self.place(
            t, self.param_spec(p, t.shape, self.layer_stack(p))))

    def shard_cache(self, cache):
        specs = self.cache_specs(cache)
        return _walk(cache, lambda p, t: self.place(t, specs[p]))

    def shard_batch(self, tree):
        return _walk(tree, lambda p, t: self.place(
            t, self.batch_spec(t.shape)))

    def replicated(self, tree):
        return _walk(tree, lambda p, t: self.place(t, (None,) * t.dim()))


def _walk(tree, fn, path: str = ""):
    """``fn(path, leaf)`` of every leaf: dicts and lists updated in place,
    tuples (a NamedTuple such as RouteState) rebuilt; returns the tree."""
    if isinstance(tree, dict):
        for k in list(tree):
            tree[k] = _walk(tree[k], fn, f"{path}/{k}" if path else str(k))
        return tree
    if isinstance(tree, list):
        for i in range(len(tree)):
            tree[i] = _walk(tree[i], fn, f"{path}/{i}" if path else str(i))
        return tree
    if isinstance(tree, tuple):
        items = [_walk(v, fn, f"{path}/{i}" if path else str(i))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return None if tree is None else fn(path, tree)


def local_shards(tree):
    """This rank's shard of every DTensor leaf, in a new tree of the same
    structure: what the engine and the kernels take."""
    if isinstance(tree, dict):
        return {k: local_shards(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [local_shards(v) for v in tree]
    if isinstance(tree, tuple):
        items = [local_shards(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return None if tree is None else tree.to_local()
