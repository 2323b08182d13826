"""Parameters from the JAX package into the port.

:func:`params_from_jax` takes either the JAX model's parameter tree, passed
as nested dicts/lists of NumPy arrays (``jax.device_get(params)``), or a
checkpoint directory in ``repro/checkpoint/checkpoint.py``'s format (one
``.npy`` per leaf named by its dotted path, plus ``manifest.json`` with
each leaf's logical dtype).  It returns the port's flat dotted-name dict of
tensors on ``device``, with every dtype kept: bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects, so their
bits are viewed as uint16 and reinterpreted as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import flatten

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(arr) -> torch.Tensor:
    """A NumPy array (including ml_dtypes bfloat16) as a CPU tensor with
    the same dtype and bits."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _from_checkpoint(directory: str) -> dict[str, torch.Tensor]:
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(directory, meta["file"]))
        t = tensor_from_numpy(arr)
        # bf16 and other narrow types are stored widened to float32
        logical = getattr(torch, meta["dtype"], None)
        if isinstance(logical, torch.dtype) and logical != t.dtype:
            t = t.to(logical)
        out[name] = t
    return out


def params_from_jax(tree_or_dir, device="cuda") -> dict[str, torch.Tensor]:
    """JAX parameters (a NumPy tree or a checkpoint directory) -> the port's
    ``{dotted name: tensor}`` on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree_or_dir, (str, os.PathLike)):
        flat = _from_checkpoint(os.fspath(tree_or_dir))
    else:
        flat = {k: tensor_from_numpy(v)
                for k, v in flatten(tree_or_dir).items()}
    return {k: v.to(dev) for k, v in flat.items()}
