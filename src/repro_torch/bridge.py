"""Parameters from the JAX package into the port.

:func:`params_from_jax` takes either the JAX model's parameter tree, passed
as nested dicts/lists of NumPy arrays (``jax.device_get(params)``), or a
checkpoint directory in ``repro/checkpoint/checkpoint.py``'s format (one
``.npy`` per leaf named by its dotted path, plus ``manifest.json`` with
each leaf's logical dtype).  It returns the port's flat dotted-name dict of
tensors on ``device``, with every dtype kept: bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects, so their
bits are viewed as uint16 and reinterpreted as ``torch.bfloat16``.

A NumPy tree may hold the reference's packed leaves — its ``QTensor``
(int8/int4 weights) and ``FactoredTensor`` (basis + per-expert delta) —
as ``jax.device_get`` returns them.  They are recognised by their
attributes, never by importing the reference, and rebuilt as the port's
``repro_torch.quant.QTensor`` / ``repro_torch.factor.FactoredTensor`` at
the same dotted name.

:func:`stub_table_from_jax` carries the reference's pseudo-embedding table
of a stub frontend (``repro.serve.engine._stub_embed_table``, drawn by
``jax.random``, which the port cannot draw) across as a host tensor; an
engine or ``LMBackend`` given it as ``stub_table`` feeds back the
reference's rows.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.factor import FactoredTensor
from repro_torch.quant import QTensor
from repro_torch.tree import flatten

__all__ = ["params_from_jax", "tensor_from_numpy", "stub_table_from_jax"]


def tensor_from_numpy(arr) -> torch.Tensor:
    """A NumPy array (including ml_dtypes bfloat16) as a CPU tensor with
    the same dtype and bits."""
    arr = np.array(arr, copy=True, order="C")   # keeps a 0-d shape
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def leaf_from_numpy(leaf):
    """One leaf of a NumPy tree as the port's: an array as a CPU tensor;
    an object with the reference QTensor's attributes (``q``, ``scale``,
    ``bits``, ``rows``, ``dtype``) as a :class:`QTensor`, and one with the
    reference FactoredTensor's (``basis``, ``u``, ``v``, ``kind``,
    ``dtype``) as a :class:`FactoredTensor` whose deltas are converted
    the same way."""
    if all(hasattr(leaf, a) for a in ("q", "scale", "bits", "rows",
                                       "dtype")):
        return QTensor(tensor_from_numpy(leaf.q),
                       tensor_from_numpy(leaf.scale), bits=leaf.bits,
                       dtype=leaf.dtype, rows=leaf.rows)
    if all(hasattr(leaf, a) for a in ("basis", "u", "v", "kind", "dtype")):
        return FactoredTensor(tensor_from_numpy(leaf.basis),
                              leaf_from_numpy(leaf.u),
                              leaf_from_numpy(leaf.v), kind=leaf.kind,
                              dtype=leaf.dtype)
    return tensor_from_numpy(leaf)


def _from_checkpoint(directory: str) -> dict[str, torch.Tensor]:
    """Every leaf of a checkpoint directory (the one holding
    ``manifest.json``), read by ``repro_torch.checkpoint``: packed leaves
    arrive as their parts (``<name>.q``, ``<name>.scale``)."""
    from repro_torch.checkpoint import read_leaves

    return read_leaves(directory)


def params_from_jax(tree_or_dir, device="cuda") -> dict[str, torch.Tensor]:
    """JAX parameters (a NumPy tree or a checkpoint directory) -> the port's
    ``{dotted name: tensor}`` on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree_or_dir, (str, os.PathLike)):
        flat = _from_checkpoint(os.fspath(tree_or_dir))
    else:
        flat = {k: leaf_from_numpy(v)
                for k, v in flatten(tree_or_dir).items()}
    return {k: v.to(dev) for k, v in flat.items()}


def stub_table_from_jax(table) -> torch.Tensor:
    """The reference's (max(vocab, 2), d) stub-frontend table (a NumPy
    array in the config's dtype) as a host tensor, to pass as
    ``stub_table`` to ``ServingEngine`` or ``LMBackend`` so they feed back
    its rows."""
    return tensor_from_numpy(table)
