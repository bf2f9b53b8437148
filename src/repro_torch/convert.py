"""Reference params -> port params.

Takes the reference model's params as a nested dict/tuple of array-likes
(``np.asarray`` must accept each leaf, as it does JAX arrays) and returns
the port's layout: the scanned ``blocks`` axis is unstacked into a list of
per-layer dicts (leading ``dense{i}`` layers first), and every weight keeps
its layout ([in, out] projections, [E, D, F] expert banks). The port does
not import JAX: the caller hands over the params.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":      # ml_dtypes bfloat16 leaves
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, fn) for v in node]
    return fn(node)


def params_from_reference(ref_params: Any, device="cpu") -> dict:
    """Convert reference decoder params (``build_decoder().init_params``)
    into the port's param dict on ``device``."""
    out = {k: _tree(v, lambda a: _tensor(a, device))
           for k, v in ref_params.items()
           if k != "blocks" and not k.startswith("dense")}
    layers = []
    n_first = sum(1 for k in ref_params if k.startswith("dense"))
    for i in range(n_first):
        layers.append(_tree(ref_params[f"dense{i}"],
                            lambda a: _tensor(a, device)))
    units = ref_params["blocks"]            # tuple over the attn pattern
    stacked = [_tree(u, lambda a: np.asarray(a)) for u in units]
    reps = len(_first_leaf(stacked[0]))
    for r in range(reps):
        for unit in stacked:
            layers.append(_tree(unit, lambda a: _tensor(a[r], device)))
    out["layers"] = layers
    return out


def _first_leaf(node):
    while isinstance(node, (dict, list)):
        node = next(iter(node.values())) if isinstance(node, dict) \
            else node[0]
    return node
