"""Sharding rules: one layout table for every (arch × mesh) cell — the port
of ``repro.dist.sharding``, with its whole logical table and parameter
patterns, term for term.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names (``("data", "model")``, ``"pod"`` where given); any
object with ``.shape`` and ``.axis_names`` (the reference's mesh, a test's
stub) also serves the pure spec logic.  A ``PartitionSpec`` is :class:`P`,
a tuple with one entry per dimension: an axis name, a tuple of names, or
None.  A ``NamedSharding`` is :class:`NamedSharding`, a spec on a mesh.

Three views of the one table, as in the reference:

  * **activations** — model code calls ``constrain(x, "btd")`` at the
    reference's sites.  The port computes explicit SPMD on plain local
    shards (``dist/spmd.py``): the layout is carried by the weights'
    blocks (a rank holding a column block of ``attn/wq`` computes its
    heads, one holding a row block of ``mlp/wd`` a partial sum), so no
    activation carries a layout to move and ``constrain`` is the
    identity; the sites mark the reference's layout.
  * **parameters** — ``param_sharding_rules`` maps every parameter name
    (``"layers.b0.attn.wq"``, matched as ``"layers/b0/attn/wq"``) to a
    :class:`NamedSharding`; stacked layers carry a leading period dim, so
    parameter specs are rank-padded on the LEFT.
  * **derived trees** — ``batch_sharding`` and ``opt_state_shardings``.

Serving over a mesh holds a leaf's block over ``model`` only
(:func:`model_spec`: the trimmed spec with its data entries dropped,
which serving keeps whole); training computes on the same blocks,
gathered over the data axes alone.  Training over a mesh stores every
leaf as its block under its spec:
``local_slice`` gives a leaf's block from its whole shape,
and :class:`TrainLayout` holds a training state's specs (the parameters'
from this table, the AdamW state's mirroring them) for the step, the
checkpoint and the dry-run.

Every spec passes through ``_trim_spec``: rank padding plus divisibility
trimming (a mesh axis that does not divide its dim is dropped).
"""

from __future__ import annotations

import contextlib
import contextvars
import re
from dataclasses import dataclass
from typing import Any, Mapping, Optional


__all__ = [
    "P", "NamedSharding", "ShardingRules", "use_rules", "current_rules",
    "constrain", "param_sharding_rules", "batch_sharding",
    "opt_state_shardings", "ep_dispatch_sharding", "axis_names",
    "axis_sizes", "_trim_spec", "_rank_pad", "_pick_spec", "local_slice",
    "shard_leaf", "opt_state_specs", "TrainLayout", "model_spec",
]


def _canonical(entry):
    """A one-name tuple entry as the name, an empty one as None (the
    reference's ``PartitionSpec`` stores them so)."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if len(entry) == 1:
            return entry[0]
        return entry or None
    return entry


class P(tuple):
    """A partition spec: one entry per dimension (an axis name, a tuple of
    names, or None).  Compares equal to the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_names(mesh) -> tuple:
    """The mesh's axis names (a ``DeviceMesh``'s ``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}: a mapping ``mesh.shape`` as it is, a
    ``DeviceMesh``'s tuple zipped with its names."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(axis_names(mesh), shape))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: P


def ep_dispatch_sharding(mesh, axis: str = "model") -> NamedSharding:
    """Sharding of the slot-major ``(S, C, d)`` expert dispatch buffer:
    ``S`` is shard-contiguous (slot ``s*R + r`` lives in shard ``s``'s
    bank), so partitioning it over the expert-parallel axis keeps every
    slot's rows with the weights they meet."""
    return NamedSharding(mesh, P(axis, None, None))


# ------------------------------------------------------------ spec trimming


def _rank_pad(shape, spec, pad_left: bool = False) -> P:
    """Pad (with None) or truncate ``spec`` to ``len(shape)`` entries."""
    entries = list(spec)
    rank = len(shape)
    if len(entries) < rank:
        pad = [None] * (rank - len(entries))
        entries = pad + entries if pad_left else entries + pad
    elif len(entries) > rank:
        entries = entries[len(entries) - rank:] if pad_left \
            else entries[:rank]
    return P(*entries)


def _trim_spec(shape, spec, mesh, pad_left: bool = False) -> P:
    """Rank-pad ``spec`` to ``shape`` and drop non-divisible mesh axes:
    names absent from the mesh are filtered out, an entry whose surviving
    axes do not divide the dim becomes None, single-name entries keep
    their string form."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, _rank_pad(shape, spec, pad_left)):
        if entry is None:
            out.append(None)
            continue
        was_str = isinstance(entry, str)
        axes = (entry,) if was_str else tuple(entry)
        axes = tuple(a for a in axes if a in sizes)
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if not axes or dim % prod != 0:
            out.append(None)
        elif was_str:
            out.append(axes[0])
        else:
            out.append(axes)
    return P(*out)


def _pick_spec(shape, spec, mesh) -> P:
    """Resolve a rule value: a plain spec, or a list of alternatives
    where the first fully divisible one wins (``"cache"``)."""
    if isinstance(spec, list):
        for alt in spec:
            trimmed = _trim_spec(shape, alt, mesh)
            if trimmed == _rank_pad(shape, alt):
                return trimmed
        spec = spec[0]
    return _trim_spec(shape, spec, mesh)


# ------------------------------------------------------------ rules object


def _batch_entry(batch_axes):
    """Batch axes as a spec entry: str for one axis, tuple for several,
    None when the mesh has no batch axis at all."""
    return batch_axes[0] if len(batch_axes) == 1 else (batch_axes or None)


class ShardingRules:
    """Immutable bundle of (mesh, logical activation table, param
    patterns)."""

    def __init__(self, mesh, logical, param_patterns, batch_axes,
                 seq_shard: bool = False, fsdp: Any = True):
        self.mesh = mesh
        self.logical = logical
        self.param_patterns = param_patterns
        self.batch_axes = batch_axes          # e.g. ("pod", "data")
        self.seq_shard = seq_shard
        self.fsdp = fsdp
        self.batch_entry = _batch_entry(batch_axes)

    @classmethod
    def for_mesh(cls, mesh, *, seq_shard: bool = False, fsdp: Any = True):
        names = axis_names(mesh)
        batch = tuple(a for a in ("pod", "data") if a in names)
        B = _batch_entry(batch)
        tp = "model" if "model" in names else None
        dp = "data" if "data" in names else None
        F = dp if fsdp is True else None              # dense-weight FSDP axis
        Fm = dp if fsdp in (True, "moe_only") else None   # expert-weight FSDP
        seq = tp if seq_shard else None

        logical = {
            # activations: (B, T, d) residual stream / (B, T, ff) MLP hidden /
            # (B, T, lru_width) recurrent widths / (B, T, vocab) logits
            "btd": P(B, seq, None),
            "btf": P(B, None, tp),
            "btw": P(B, None, tp),
            "btv": P(B, None, tp),
            # attention: heads over the tensor axis
            "bhsd": P(B, tp, None, None),
            "bkvsd": P(B, tp, None, None),
            # KV cache (B, Hkv, S, hd): head-sharded when Hkv divides the
            # tensor axis, else batch-only
            "cache": [P(B, tp, None, None), P(B, None, None, None)],
            # MoE dispatch buffers (E, C, d): expert-parallel over the
            # tensor axis
            "ecd": P(tp, None, None),
            # paged-serving slot dispatch buffers (S, C, d): shard-
            # contiguous slot banks (see ep_dispatch_sharding)
            "scd": P(tp, None, None),
        }

        param_patterns = (
            # --- embeddings / head: vocab over tensor, d over FSDP
            (r"embed/tokens$",              P(tp, F)),
            (r"head/w$",                    P(F, tp)),
            # --- attention
            (r"attn/w[qkv]$",               P(F, tp)),
            (r"attn/wo$",                   P(tp, F)),
            (r"attn/b[qkv]$",               P(tp)),
            # --- dense MLP (swiglu/geglu/gelu)
            (r"mlp/(wg|wu|w1)$",            P(F, tp)),
            (r"mlp/(wd|w2)$",               P(tp, F)),
            (r"mlp/b1$",                    P(tp)),
            (r"mlp/b2$",                    P()),
            # --- MoE: gate replicated; expert stacks expert-dim over the
            # tensor axis (resident experts for ep_local) + FSDP over data
            (r"moe/gate$",                  P(None, None, None)),
            (r"moe/shared_w[gu]$",          P(F, tp)),
            (r"moe/shared_wd$",             P(tp, F)),
            (r"moe/(wg|wu|wd|w1|w2)$",      P(tp, Fm, None)),
            (r"moe/b[12]$",                 P(tp, None)),
            # --- RG-LRU (recurrentgemma)
            (r"rglru/w_up2?$",              P(F, tp)),
            (r"rglru/w_down$",              P(tp, F)),
            (r"rglru/conv$",                P(None, tp)),
            (r"rglru/gates$",               P(tp, None, None)),
            (r"rglru/lam$",                 P(tp)),
            # --- xLSTM (mlstm / slstm)
            (r"(mlstm|slstm)/w_(up|up2|gates|qkv)$", P(F, tp)),
            (r"(mlstm|slstm)/w_down$",      P(tp, F)),
            (r"mlstm/conv$",                P(None, tp)),
            (r"mlstm/w_if$",                P(F, None)),
            (r"slstm/r_gates$",             P(tp, None, None)),
            # --- quantized (QTensor) leaves <name>/q and <name>/scale:
            # expert stacks keep the expert-dim layout, other quantized
            # weights replicate
            (r"moe/(wg|wu|wd|w1|w2)/(q|scale)$", P(tp, Fm, None)),
            (r"/(q|scale)$",                P()),
            # --- norms / small vectors: replicated
            (r"(scale|bias|b_if|b_gates|gn_scale|lam|pos)$", P()),
        )
        return cls(mesh, logical, param_patterns, batch,
                   seq_shard=seq_shard, fsdp=fsdp)


# ------------------------------------------------------------ rules context


_RULES: contextvars.ContextVar[Optional[ShardingRules]] = \
    contextvars.ContextVar("repro_torch_sharding_rules", default=None)


def current_rules() -> Optional[ShardingRules]:
    return _RULES.get()


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Activate ``rules`` for the dynamic extent (None is a valid no-op
    value); nests, restoring the previous value on exit."""
    token = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(token)


def constrain(x, name: str):
    """Constrain ``x`` to the logical rule ``name``: the identity.  The
    port computes on plain local shards (a rank's rows, its experts, its
    heads and its columns of a dense weight), whose layout the weights'
    blocks carry; the call sites are the reference's."""
    return x


# ------------------------------------------------------------ param tables


def _path_str(name: str) -> str:
    """A flat dotted parameter name as the reference's path string."""
    return name.replace(".", "/")


def _match_param_spec(pathstr: str, shape, rules: ShardingRules) -> P:
    for pattern, spec in rules.param_patterns:
        if re.search(pattern, pathstr):
            # pad LEFT: stacked layers carry a leading period dim that
            # the per-layer pattern spec doesn't mention
            return _trim_spec(shape, spec, rules.mesh, pad_left=True)
    raise ValueError(
        f"no sharding rule matches parameter {pathstr!r} (shape {shape}); "
        f"add a pattern to ShardingRules.for_mesh")


def _leaves(tree, prefix=""):
    """(dotted name, leaf) of a flat or nested dict of tensors; a packed
    leaf (QTensor) flattens to ``<name>.q`` / ``<name>.scale``."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
        return
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        yield from _leaves({"q": tree.q, "scale": tree.scale}, prefix)
        return
    yield prefix[:-1], tree


def param_sharding_rules(tree, rules: ShardingRules) -> dict:
    """Parameters (a flat or nested dict of tensors or anything with a
    ``.shape``) -> {dotted name: NamedSharding}."""
    return {name: NamedSharding(rules.mesh, _match_param_spec(
        _path_str(name), tuple(leaf.shape), rules))
        for name, leaf in _leaves(tree)}


def batch_sharding(tree, rules: ShardingRules) -> dict:
    """Batch/state trees: leading dim over the batch axes, scalars
    replicated, other dims unsharded; {dotted name: NamedSharding}."""
    entry = rules.batch_entry

    def one(leaf):
        if len(leaf.shape) == 0 or entry is None:
            return NamedSharding(rules.mesh, P())
        return NamedSharding(rules.mesh,
                             _trim_spec(tuple(leaf.shape), P(entry),
                                        rules.mesh))

    return {name: one(leaf) for name, leaf in _leaves(tree)}


def opt_state_shardings(opt_state, params, rules: ShardingRules) -> dict:
    """AdamW state shardings from the parameter table: ``m``/``v`` mirror
    the parameter's spec; the factored ``vr`` (row stats) drops the last
    entry and ``vc`` (col stats) the -2 one.  ``params`` is accepted for
    symmetry with the other builders."""
    del params
    mesh = rules.mesh
    ema = {}
    for name, st in opt_state["ema"].items():
        spec = _match_param_spec(_path_str(name), tuple(st["m"].shape),
                                 rules)
        out = {"m": NamedSharding(mesh, spec)}
        if "v" in st:
            out["v"] = NamedSharding(mesh, spec)
        if "vr" in st:
            out["vr"] = NamedSharding(mesh, P(*spec[:-1]))
        if "vc" in st:
            out["vc"] = NamedSharding(mesh, P(*spec[:-2], spec[-1]))
        ema[name] = out
    return {"step": NamedSharding(mesh, P()), "ema": ema}


# ------------------------------------------------------------ local blocks


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_slice(shape, spec, mesh) -> tuple:
    """This rank's block of a leaf of whole ``shape`` under ``spec``, as
    one slice a dim: a dim over several axes takes them major first (the
    reference's spec order).  A device-free mesh (``dist.spmd.
    VirtualMesh``) is rank 0."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, _rank_pad(shape, spec)):
        n, index = 1, 0
        for a in _axes(entry):
            if a in sizes:
                n *= sizes[a]
                index = index * sizes[a] + mesh.get_local_rank(a)
        per = dim // n
        out.append(slice(index * per, (index + 1) * per))
    return tuple(out)


def model_spec(spec) -> P:
    """A trimmed spec with only its ``"model"`` entries: the block a
    serving rank holds (the data axes stay whole in serving; a dim over
    ``model`` and another axis keeps ``model`` alone)."""
    return P(*("model" if "model" in _axes(e) else None for e in spec))


def shard_leaf(t, spec, mesh):
    """This rank's block of the whole tensor ``t`` under ``spec``, a
    tensor of its own (the whole one can be freed)."""
    return t[local_slice(tuple(t.shape), spec, mesh)].clone()


def opt_state_specs(opt_state, specs: dict) -> dict:
    """The AdamW state's specs from its parameters' (``specs``), as
    :func:`opt_state_shardings` derives them: ``m``/``v`` mirror the
    parameter's, the factored ``vr`` drops the last entry and ``vc`` the
    -2 one, ``step`` is replicated.  The state may be local blocks: the
    specs come from the parameters' whole shapes."""
    ema = {}
    for name, st in opt_state["ema"].items():
        spec = _rank_pad(st["m"].shape, specs[name])
        out = {"m": spec}
        if "v" in st:
            out["v"] = spec
        if "vr" in st:
            out["vr"] = P(*spec[:-1])
        if "vc" in st:
            out["vc"] = P(*spec[:-2], spec[-1])
        ema[name] = out
    return {"step": P(), "ema": ema}


@dataclass(frozen=True)
class TrainLayout:
    """Where a training state's leaves live over ``rules.mesh``: each
    parameter's spec on its whole shape (``params``), the axes its
    gather leaves local (``keep``: ``model`` for every leaf a rank
    computes on its block of — the tensor-parallel dense blocks, RG-LRU
    mixers and xLSTM mixers (where ``model`` divides their heads), and
    the expert stacks of an ``ep_local`` layer)."""

    rules: ShardingRules
    params: dict
    keep: dict

    @classmethod
    def build(cls, shapes: dict, rules: ShardingRules, extra=(),
              blocks=()) -> "TrainLayout":
        """From a parameter tree of whole shapes (tensors on ``meta`` will
        do).  ``extra``: (pattern, spec) pairs for parameters the table
        has no rule for, tried after it.  ``blocks``: the names computed
        on their block over ``model`` (``transformer.model_blocks``, an
        ``ep_local`` layer's expert stacks among them)."""
        table = rules if not extra else ShardingRules(
            rules.mesh, rules.logical, rules.param_patterns + tuple(extra),
            rules.batch_axes, seq_shard=rules.seq_shard, fsdp=rules.fsdp)
        specs = {k: v.spec for k, v in
                 param_sharding_rules(shapes, table).items()}
        return cls(rules, specs,
                   {k: ("model",) for k in specs if k in blocks})

    @property
    def mesh(self):
        return self.rules.mesh

    def tree_specs(self, tree: dict) -> dict:
        """{dotted name: spec} of a ``{"params", "opt"}`` state tree
        (the checkpoint's), in its dotted names."""
        out = {f"params.{k}": v for k, v in self.params.items()}
        opt = opt_state_specs(tree["opt"], self.params)
        out["opt.step"] = opt["step"]
        for name, st in opt["ema"].items():
            for leaf, spec in st.items():
                out[f"opt.ema.{name}.{leaf}"] = spec
        return out

    def shard_params(self, params: dict) -> dict:
        """This rank's blocks of whole parameters."""
        return {k: shard_leaf(v, self.params[k], self.mesh)
                for k, v in params.items()}

    def shard_opt_state(self, opt_state: dict) -> dict:
        """This rank's blocks of a whole AdamW state."""
        specs = opt_state_specs(opt_state, self.params)
        return {"step": opt_state["step"].clone(), "ema": {
            name: {leaf: shard_leaf(t, specs["ema"][name][leaf], self.mesh)
                   for leaf, t in st.items()}
            for name, st in opt_state["ema"].items()}}
