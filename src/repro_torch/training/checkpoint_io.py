"""Model weight checkpoints (port of ``repro.training.checkpoint_io``):
an npz of the params keyed by leaf path ("layers/3/attn/wq"), with the
step under ``__step__``, published atomically (written to ``path.tmp``,
then ``os.replace``).

numpy has no bfloat16: a bfloat16 leaf is stored as its raw 16 bits
(uint16) and read back bit for bit. ``load_params`` also takes the
reference's files, whose bfloat16 leaves numpy reads as 2-byte void
arrays. (KV-cache checkpointing, the paper's contribution, is
``core/checkpoint.py``; this is the ordinary weights substrate.)
"""
from __future__ import annotations

import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.training.train import leaf_paths, tree_unflatten


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.itemsize == 2 and arr.dtype.kind in "uV":  # bf16 bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save_params(path: str, params, step: int = 0):
    arrays = {k: _to_numpy(v) for k, v in leaf_paths(params).items()}
    arrays["__step__"] = np.asarray(step)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic publish


def load_params(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` on its devices: each leaf's
    shape is checked and the leaf cast to ``like``'s dtype."""
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else 0
        leaves = []
        for key, ref in leaf_paths(like).items():
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{path}: {key} has shape {arr.shape}, "
                                 f"expected {tuple(ref.shape)}")
            leaves.append(_from_numpy(arr, ref))
    return tree_unflatten(like, leaves), step
