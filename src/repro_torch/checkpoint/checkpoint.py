"""Atomic checkpointing with async writes, the port of
``repro.checkpoint.checkpoint``, in its on-disk format:

  * one ``.npy`` per leaf, named by the leaf's dotted path (the port's
    flat dotted-name parameter dicts nest under the tree's keys, so a
    parameter ``layers.b0.attn.wq`` under ``params`` is the reference's
    ``params.layers.b0.attn.wq``; list items by index), plus
    ``manifest.json`` with each leaf's file, logical dtype and shape;
  * bf16 (and any dtype NumPy cannot hold) stored widened to float32,
    cast back on restore from the manifest's logical dtype;
  * packed leaves as their parts: a ``QTensor`` as ``<name>.q`` and
    ``<name>.scale``, a ``FactoredTensor`` as ``<name>.basis``,
    ``<name>.u`` and ``<name>.v`` (a quantized delta nests:
    ``<name>.u.q``) — the reference's pytree key paths;
  * atomic: written to ``<dir>/tmp.<step>`` and renamed to
    ``<dir>/step_<step>`` once every leaf and the manifest are on disk;
  * :class:`CheckpointManager` copies to the host on the caller's thread
    and writes on a thread of its own, keeping the newest ``keep``.

So a checkpoint written by either package restores in the other.

Over a mesh (a ``dist.sharding.TrainLayout`` given) a state's leaves are
the ranks' blocks, and the checkpoint is still the whole tree in the
format above: every rank gathers each leaf whole (a collective), rank 0
writes, and every rank waits for the write at a barrier.  ``restore``
narrows each whole leaf to the rank's block.  So a checkpoint taken over
a mesh restores without one, and the reverse.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import tensor_from_numpy
from repro_torch.dist import spmd
from repro_torch.factor import FactoredTensor
from repro_torch.quant import QTensor

__all__ = ["save", "restore", "latest_step", "read_leaves",
           "CheckpointManager"]

_MANIFEST = "manifest.json"
_NUMPY_KEEPS = (np.float32, np.float64, np.int32, np.int64, np.int8,
                np.uint8, np.bool_, np.float16)


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    """Leaves by dotted path; packed leaves by their parts."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif isinstance(tree, QTensor):
        items = (("q", tree.q), ("scale", tree.scale))
    elif isinstance(tree, FactoredTensor):
        items = (("basis", tree.basis), ("u", tree.u), ("v", tree.v))
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for key, sub in items:
        out.update(_flatten(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _host_leaves(tree) -> dict[str, tuple[np.ndarray, str]]:
    """Every leaf copied to the host as a NumPy array NumPy can store
    (bf16 and the like widened to float32), with its logical dtype name."""
    out = {}
    for name, leaf in _flatten(tree).items():
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            logical = str(t.dtype).removeprefix("torch.")
            arr = t.float().numpy() if t.dtype == torch.bfloat16 \
                else t.numpy()
        else:
            arr = np.asarray(leaf)
            logical = str(arr.dtype)
        if arr.dtype not in _NUMPY_KEEPS:
            arr = arr.astype(np.float32)
        out[name] = (arr, logical)
    return out


def _write(directory: str, step: int, leaves: dict) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for name, (arr, logical) in leaves.items():
        fname = name.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][name] = {"file": fname, "dtype": logical,
                                    "shape": list(arr.shape)}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    return final


def _whole(tree, layout) -> dict:
    """The ``{"params", "opt"}`` state of blocks ``tree`` gathered whole
    on every rank, by dotted name."""
    specs = layout.tree_specs(tree)
    with torch.no_grad():
        return {name: spmd.gather_param(leaf, specs[name], layout.mesh,
                                        where="checkpoint")
                for name, leaf in _flatten(tree).items()}


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def save(directory: str, step: int, tree, layout=None) -> str:
    """Synchronous atomic save.  Returns the final checkpoint path.
    ``layout``: ``tree`` is a rank's blocks over a mesh (every rank calls
    this; rank 0 writes the whole tree)."""
    if layout is None:
        return _write(directory, step, _host_leaves(tree))
    leaves = _host_leaves(_whole(tree, layout))
    path = os.path.join(directory, f"step_{step}")
    if spmd.rank() == 0:
        path = _write(directory, step, leaves)
    _barrier()
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, _MANIFEST)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _load(ckpt: str, meta: dict) -> torch.Tensor:
    """One leaf as a CPU tensor in its logical dtype."""
    t = tensor_from_numpy(np.load(os.path.join(ckpt, meta["file"])))
    logical = getattr(torch, meta["dtype"], None)
    if isinstance(logical, torch.dtype) and logical != t.dtype:
        t = t.to(logical)
    return t


def read_leaves(ckpt: str) -> dict[str, torch.Tensor]:
    """Every leaf of one checkpoint directory (``<dir>/step_<n>``, or any
    directory holding a manifest), by dotted name, as CPU tensors in their
    logical dtypes; packed leaves stay as their parts."""
    with open(os.path.join(ckpt, _MANIFEST)) as f:
        leaves = json.load(f)["leaves"]
    return {name: _load(ckpt, meta) for name, meta in leaves.items()}


def restore(directory: str, step: int, like, layout=None):
    """Restore into the structure of ``like``: each tensor leaf in the
    like leaf's dtype on its device, QTensor and FactoredTensor leaves
    rebuilt with the like leaf's metadata.  ``layout``: ``like`` is a
    rank's blocks over a mesh; each whole leaf is narrowed to its block."""
    from repro_torch.dist.sharding import shard_leaf

    ckpt = os.path.join(directory, f"step_{step}")
    with open(os.path.join(ckpt, _MANIFEST)) as f:
        leaves = json.load(f)["leaves"]
    specs = {} if layout is None else layout.tree_specs(like)

    def load(node, name):
        if isinstance(node, dict):
            return {k: load(v, f"{name}.{k}" if name else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(load(v, f"{name}.{i}" if name else str(i))
                              for i, v in enumerate(node))
        if isinstance(node, QTensor):
            return QTensor(load(node.q, f"{name}.q"),
                           load(node.scale, f"{name}.scale"),
                           bits=node.bits, dtype=node.dtype, rows=node.rows)
        if isinstance(node, FactoredTensor):
            return FactoredTensor(load(node.basis, f"{name}.basis"),
                                  load(node.u, f"{name}.u"),
                                  load(node.v, f"{name}.v"),
                                  kind=node.kind, dtype=node.dtype)
        meta = leaves.get(name)
        if meta is None:
            raise KeyError(f"checkpoint {ckpt} missing leaf {name}")
        t = _load(ckpt, meta)
        if name in specs:
            t = shard_leaf(t, specs[name], layout.mesh)
        if tuple(t.shape) != tuple(node.shape):
            raise ValueError(f"leaf {name}: checkpoint shape "
                             f"{tuple(t.shape)} != live {tuple(node.shape)}")
        if isinstance(node, torch.Tensor):
            return t.to(device=node.device, dtype=node.dtype)
        return t.numpy().astype(np.asarray(node).dtype)

    return load(like, "")


class CheckpointManager:
    """Async writer + retention.  One in-flight save at a time.  With a
    ``layout`` every rank calls :meth:`save` (the leaves are gathered
    whole), rank 0 writes, and :meth:`wait` ends at a barrier."""

    def __init__(self, directory: str, keep: int = 3, layout=None):
        self.directory = directory
        self.keep = keep
        self.layout = layout
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree) -> None:
        self.wait()
        # the device-to-host copy happens on the caller's thread (a
        # consistent snapshot); the disk writes on the writer thread
        if self.layout is not None:
            tree = _whole(tree, self.layout)
            if spmd.rank() != 0:
                return
        host = _host_leaves(tree)

        def work():
            try:
                _write(self.directory, step, host)
                self._gc()
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.layout is not None:
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1))
            for name in os.listdir(self.directory)
            if (m := re.fullmatch(r"step_(\d+)", name)))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def latest(self) -> int | None:
        return latest_step(self.directory)
