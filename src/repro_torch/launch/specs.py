"""Shape-only stand-ins for every model input, on the ``meta`` device:
shardable, zero allocation (port of ``repro.launch.specs``, where
``ShapeDtypeStruct`` and ``jax.eval_shape`` play this part).

``build_case`` assembles what one (arch x shape x mesh) combination needs
for the dry run: the config adapted to the shape, the model, its params,
the AdamW state (train), the batch and the cache (decode), all on
``meta``, with the ``Sharder``'s spec of every leaf. Meta tensors never
reach a kernel (``kernels/ops.py`` raises): the dry run places and counts
the leaves, it does not run the step.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.sharding import Sharder, ShardingPolicy
from repro_torch.models.registry import get_model
from repro_torch.training.train import init_opt_state, leaf_paths

META = torch.device("meta")

# Long-context variants: archs whose full-attention layers get a sliding
# window for the 500k decode shape.
LONG_VARIANT_WINDOW = {"zamba2-7b": 8192, "gemma2-2b": 4096}


def adapt_config(cfg: ModelConfig, shape: ShapeConfig,
                 dtype: str = "bfloat16") -> ModelConfig:
    cfg = dataclasses.replace(cfg, dtype=dtype)
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    if shape.name == "long_500k" and cfg.name in LONG_VARIANT_WINDOW:
        win = LONG_VARIANT_WINDOW[cfg.name]
        if cfg.sliding_window == 0:
            cfg = dataclasses.replace(cfg, sliding_window=win)
    return cfg


def batch_structs(cfg: ModelConfig, shape: ShapeConfig, *,
                  with_labels: bool) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    if with_labels:
        batch["labels"] = torch.empty((b, s), dtype=torch.int32,
                                      device=META)
    if cfg.is_encdec:
        batch["frames"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                      dtype=cfg.torch_dtype, device=META)
    return batch


@dataclass
class DryrunCase:
    name: str
    cfg: ModelConfig
    shape: ShapeConfig
    sharder: Sharder
    params: Any
    batch: Dict[str, torch.Tensor]
    route_state: Any
    opt_state: Any = None          # train
    cache: Any = None              # decode
    param_specs: Dict[str, tuple] = field(default_factory=dict)
    cache_specs: Dict[str, tuple] = field(default_factory=dict)

    @property
    def param_shapes(self) -> Dict[str, tuple]:
        return {p: tuple(t.shape) for p, t in leaf_paths(self.params)
                .items()}

    @property
    def cache_shapes(self) -> Dict[str, tuple]:
        if self.cache is None:
            return {}
        return {p: tuple(t.shape) for p, t in leaf_paths(self.cache)
                .items()}

    def bytes_per_device(self) -> Dict[str, float]:
        """One device's shard bytes of params, optimizer state (its
        moments take the params' specs), cache and batch."""
        sh = self.sharder

        def local(t, spec):
            return t.element_size() * math.prod(sh.local_shape(t.shape,
                                                               spec))
        params = leaf_paths(self.params)
        out = {"params": float(sum(local(t, self.param_specs[p])
                                   for p, t in params.items()))}
        if self.opt_state is not None:
            mu = leaf_paths(self.opt_state.mu)
            out["opt_state"] = 2.0 * sum(local(t, self.param_specs[p])
                                         for p, t in mu.items())
        if self.cache is not None:
            out["cache"] = float(sum(
                local(t, self.cache_specs[p])
                for p, t in leaf_paths(self.cache).items()))
        out["batch"] = float(sum(local(t, sh.batch_spec(t.shape))
                                 for t in self.batch.values()))
        return out


def build_case(arch: str, shape_name: str, mesh,
               policy: Optional[ShardingPolicy] = None,
               tarragon: bool = True, dtype: str = "bfloat16") -> DryrunCase:
    shape = SHAPES[shape_name]
    cfg = adapt_config(get_config(arch), shape, dtype)
    if policy is None:
        policy = ShardingPolicy(
            expert_ff_over_data=(cfg.name == "kimi-k2-1t-a32b"),
            zero_over_pod=(shape.kind == "train"))
    sizes = axis_sizes(mesh)
    api = get_model(cfg, num_aw=sizes["data"], num_ew=sizes["model"],
                    tarragon=tarragon, device=META)
    sharder = Sharder(cfg, mesh, policy)
    params = api.init_params(torch.Generator())
    case = DryrunCase(name=f"{arch}:{shape_name}:{shape.kind}", cfg=cfg,
                      shape=shape, sharder=sharder, params=params,
                      batch=batch_structs(cfg, shape,
                                          with_labels=shape.kind == "train"),
                      route_state=api.init_route_state(),
                      param_specs=sharder.param_specs(params))
    if shape.kind == "train":
        case.opt_state = init_opt_state(params)
    elif shape.kind == "decode":
        # ONE new token against a seq_len cache
        case.cache = api.init_cache(shape.global_batch, shape.seq_len)
        case.cache_specs = sharder.cache_specs(case.cache)
        case.batch = {
            "tokens": torch.empty((shape.global_batch,), dtype=torch.int32,
                                  device=META),
            "pos": torch.empty((shape.global_batch,), dtype=torch.int32,
                               device=META)}
    return case
