"""Tile schedules: per-(op, shape bucket, backend) block sizes — the port
of ``repro.ops.schedules`` over its own table (``schedules.json`` beside
this module).

Resolution order for a block, strongest last (the reference's):

  1. the table's ``defaults`` for ``"<op>.<impl>"``;
  2. every ``buckets`` entry whose ``min`` dims the call shape meets
     (listed ascending, so the tightest match wins);
  3. the ambient :class:`~repro_torch.ops.policy.ComputePolicy`'s
     ``tiles`` override (applied by ``registry.dispatch``).

The backends are ``"cuda"`` (operands on the card) and ``"cpu"``;
``cuda`` falls back to ``cpu`` for a key it lacks, as the reference's
``tpu`` falls back to ``interpret``.  The ``cpu`` section holds the plain
impls that take blocks (``attention.blocked``: the reference's
``interpret`` entry); the ``cuda`` section holds only the knobs a Hopper
kernel takes and some path selects.  It is empty: the GEMM planners
(``kernels/gemm_plan.py``) pick each launch's tile from its shape, and the
attention kernels have one instance of their query and key tiles each.

:func:`check_override` is the dispatch's guard: a policy override naming
a block the impl does not take raises ``ValueError``, and on the card a
kernel impl with no knobs refuses any override.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional

__all__ = ["schedule_for", "load_table", "table_entries", "backend_key",
           "knobs", "check_override"]

_TABLE_PATH = os.path.join(os.path.dirname(__file__), "schedules.json")


@functools.lru_cache(maxsize=None)
def load_table(path: Optional[str] = None) -> dict:
    with open(path or _TABLE_PATH) as f:
        table = json.load(f)
    if "backends" not in table:
        raise ValueError(f"schedule table {path or _TABLE_PATH} has no "
                         "'backends' section")
    return table


def backend_key(device=None) -> str:
    """``"cuda"`` for operands on the card, ``"cpu"`` for any other
    device (the kernel modules run their plain versions there)."""
    kind = getattr(device, "type", device)
    return "cuda" if kind == "cuda" else "cpu"


def table_entries(path: Optional[str] = None) -> dict:
    """Flat {backend: {op.impl: entry}} view, for validation tooling."""
    return load_table(path)["backends"]


def _entry(op: str, impl: str, backend: str, path=None) -> Optional[dict]:
    backends = load_table(path)["backends"]
    key = f"{op}.{impl}"
    entry = backends.get(backend, {}).get(key)
    if entry is None and backend != "cpu":
        entry = backends.get("cpu", {}).get(key)
    return entry


def _bucket_matches(min_dims: dict, dims: dict) -> bool:
    return all(dims.get(k, 0) >= v for k, v in min_dims.items())


def schedule_for(op: str, impl: str, dims: Optional[dict] = None,
                 backend: Optional[str] = None,
                 path: Optional[str] = None) -> dict:
    """Resolved blocks for ``op`` served by ``impl`` at shape ``dims``
    (attention: sq/skv/d; linear: m/n/k; moe: e/c/d/f).  Unknown keys
    return {} (the impl's planner or own default decides)."""
    entry = _entry(op, impl, backend or "cpu", path)
    if entry is None:
        return {}
    blocks = dict(entry.get("defaults", {}))
    dims = dims or {}
    for bucket in entry.get("buckets", ()):
        if _bucket_matches(bucket.get("min", {}), dims):
            blocks.update({k: v for k, v in bucket.items() if k != "min"})
    return blocks


def knobs(op: str, impl: str, backend: str = "cpu",
          path: Optional[str] = None) -> Optional[tuple]:
    """The blocks ``impl`` of ``op`` takes on ``backend``; None when the
    table has no entry for it."""
    entry = _entry(op, impl, backend, path)
    return None if entry is None else tuple(entry.get("knobs", ()))


def check_override(op: str, impl: str, override: dict, backend: str,
                   kernel: bool) -> None:
    """Raise ``ValueError`` for a policy tile override the serving impl
    cannot take: a block outside its knobs, or any block for a kernel
    impl with no knobs that runs on the card.  A plain impl with no table
    entry ignores overrides, as the reference's ``xla`` impls do."""
    if not override:
        return
    names = knobs(op, impl, backend)
    if names is None:
        if kernel and backend == "cuda":
            raise ValueError(
                f"{op}.{impl} takes no tile override on the card (its "
                f"kernel has one tile instance); got {override}")
        return
    unknown = sorted(set(override) - set(names))
    if unknown:
        raise ValueError(f"{op}.{impl}: unknown tile block(s) {unknown}; "
                         f"it takes {list(names)}")
