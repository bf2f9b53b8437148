"""Reference params -> port params.

Takes the reference model's params as a nested dict/tuple of array-likes
(``np.asarray`` must accept each leaf, as it does JAX arrays) and returns
the port's layout: the scanned ``blocks`` axis is unstacked into a list of
per-layer dicts (leading ``dense{i}`` layers first; an xLSTM's units the
same way, into ``blocks``), the hybrid's stacked Mamba2 blocks into one
list in execution order, Whisper's stacked ``enc`` and ``dec`` layers
into two lists, and every weight keeps its layout ([in, out]
projections, [E, D, F] expert banks). The port does not import JAX: the
caller hands over the params.
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


def tree_map(node, fn):
    """``fn`` of every leaf of a nested dict/list/tuple, in its structure
    (a tuple becomes a list)."""
    if isinstance(node, dict):
        return {k: tree_map(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [tree_map(v, fn) for v in node]
    return fn(node)


def params_from_reference(ref_params: Any, device="cuda") -> dict:
    """Convert reference params (``init_params`` of ``build_decoder``,
    ``build_hybrid``, ``build_xlstm`` or ``build_encdec``) into the port's
    param dict on ``device``. Any tree of the params' structure converts
    the same way: the reference's gradients (``jax.grad`` of a loss over
    the params) or its optimizer moments."""
    if "units" in ref_params:
        return _hybrid_from_reference(ref_params, device)
    if "enc" in ref_params:
        return _encdec_from_reference(ref_params, device)
    out = {k: tree_map(v, lambda a: _tensor(a, device))
           for k, v in ref_params.items()
           if k != "blocks" and not k.startswith("dense")}
    layers = []
    n_first = sum(1 for k in ref_params if k.startswith("dense"))
    for i in range(n_first):
        layers.append(tree_map(ref_params[f"dense{i}"],
                            lambda a: _tensor(a, device)))
    # a tuple over the unit's pattern (attention kinds, or an xLSTM's
    # mLSTM/sLSTM cells), each stacked over the unit's repeats
    units = ref_params["blocks"]
    stacked = [tree_map(u, lambda a: np.asarray(a)) for u in units]
    reps = len(_first_leaf(stacked[0]))
    for r in range(reps):
        for unit in stacked:
            layers.append(tree_map(unit, lambda a: _tensor(a[r], device)))
    out["blocks" if "cell" in stacked[0] else "layers"] = layers
    return out


def _first_leaf(node):
    while isinstance(node, (dict, list)):
        node = next(iter(node.values())) if isinstance(node, dict) \
            else node[0]
    return node


def _hybrid_from_reference(ref_params, device) -> dict:
    """The hybrid's stacked Mamba2 blocks (``units`` [r, every, ...], then
    ``trailing`` [t, ...]) become one ``blocks`` list in execution
    order; ``shared`` and the rest keep their layout."""
    out = {k: tree_map(v, lambda a: _tensor(a, device))
           for k, v in ref_params.items() if k not in ("units", "trailing")}
    units = tree_map(ref_params["units"], np.asarray)
    r, every = _first_leaf(units).shape[:2]
    blocks = [tree_map(units, lambda a, u=u, j=j: _tensor(a[u, j], device))
              for u in range(r) for j in range(every)]
    if "trailing" in ref_params:
        tr = tree_map(ref_params["trailing"], np.asarray)
        blocks += [tree_map(tr, lambda a, i=i: _tensor(a[i], device))
                   for i in range(_first_leaf(tr).shape[0])]
    out["blocks"] = blocks
    return out


def _encdec_from_reference(ref_params, device) -> dict:
    """Whisper's stacked ``enc`` and ``dec`` layers become two lists in
    execution order; the embedding and the norms keep their layout."""
    out = {k: tree_map(v, lambda a: _tensor(a, device))
           for k, v in ref_params.items() if k not in ("enc", "dec")}
    for name in ("enc", "dec"):
        st = tree_map(ref_params[name], np.asarray)
        out[name] = [tree_map(st, lambda a, i=i: _tensor(a[i], device))
                     for i in range(_first_leaf(st).shape[0])]
    return out
