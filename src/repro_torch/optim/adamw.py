"""AdamW, the port of ``repro.optim.adamw``: functional over the flat
dotted-name parameter dict (``repro_torch.tree``).

  * float32 or bf16 first moment (``momentum_dtype``);
  * a factored (Adafactor-style row/column) second moment for matrices of
    at least ``factored_min_size`` on both sides;
  * global-norm gradient clipping;
  * decoupled weight decay, none on the names ``_no_decay`` matches
    (norm scales, biases, positions — the reference's suffix rule, matched
    on the dotted name);
  * a cosine schedule with linear warmup.

The state mirrors the reference's tree: ``{"step": int32 scalar, "ema":
{<param name>: {"m", "v"} or {"m", "vr", "vc"}}}``, so its dotted names
(``step``, ``ema.<param>.m`` …) are the reference's checkpoint leaves.
Every step computes in float32 — the schedule and bias corrections from
the step counter on the parameters' device (no host read), each update
elementwise — and casts back to the parameter's dtype with round to
nearest even, as the reference does.  Inputs are never written: the
update returns new tensors.

Over a mesh (``specs`` and ``mesh`` given, ``train/step.py``) every leaf
is a rank's block under its spec.  The update is elementwise, so a block
updates as the whole leaf would; the two statistics over whole leaves
are all-reduced: each leaf's sum of squares in the global norm over the
axes it is sharded on (a replicated block counts once), and the
factored second moment's row and column means where their dim is
sharded.  The clip scale is then one device's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.roofline.scope import scope

__all__ = ["OptConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    momentum_dtype: str = "float32"     # "bfloat16" halves m-state memory
    factored: bool = False              # Adafactor-style v for ndim>=2 params
    factored_min_size: int = 128        # don't factor small matrices


def cosine_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor) as a float32
    tensor: linear warmup, then cosine down to ``min_lr_frac``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _tree_order(names):
    """The reference's leaf order: dict keys sorted at every level."""
    return sorted(names, key=lambda n: n.split("."))


def _live_axes(entry, mesh) -> list:
    """The axes of a spec entry that split their dim over more than one
    rank."""
    from repro_torch.dist.spmd import axis_size

    if entry is None:
        return []
    axes = (entry,) if isinstance(entry, str) else entry
    return [a for a in axes if axis_size(mesh, a) > 1]


def _spec_axes(spec) -> list:
    return [a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)]


def global_norm(tree: dict, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    summed in the reference's tree order.  With ``specs`` each leaf is a
    block: its sum of squares is summed over the axes of its spec, one
    all-reduce an axis for all the leaves together."""
    from repro_torch.dist import spmd

    names = _tree_order(tree)
    sq = [torch.sum(torch.square(tree[n].float())) for n in names]
    if specs is not None and names:
        v = torch.stack(sq)
        axes = [_spec_axes(specs[n]) for n in names]
        for a in spmd.axis_names(mesh):
            flags = [a in ax for ax in axes]
            if any(flags):
                member = torch.tensor(flags, device=v.device)
                v = torch.where(member, spmd.all_reduce(
                    v * member, mesh, a, "adamw global norm"), v)
        sq = list(v.unbind())
    total = None
    for x in sq:
        total = x if total is None else total + x
    return torch.sqrt(total)


def _mean(t, dim: int, entry, mesh, keepdim: bool = False):
    """``t.mean(dim)`` of a block whose ``dim`` is split over ``entry``'s
    axes: the partial sums over the whole dim's length, all-reduced."""
    from repro_torch.dist import spmd

    live = [] if mesh is None else _live_axes(entry, mesh)
    if not live:
        return t.mean(dim, keepdim=keepdim)
    n = t.shape[dim]
    for a in live:
        n *= spmd.axis_size(mesh, a)
    part = t.sum(dim, keepdim=keepdim) / n
    for a in live:
        part = spmd.all_reduce(part, mesh, a, "adamw factored mean")
    return part


def _is_factored(p, cfg: OptConfig) -> bool:
    return (cfg.factored and p.dim() >= 2
            and p.shape[-1] >= cfg.factored_min_size
            and p.shape[-2] >= cfg.factored_min_size)


def adamw_init(params: dict, cfg: OptConfig) -> dict:
    """Zeroed state on the parameters' device."""
    mdtype = getattr(torch, cfg.momentum_dtype)
    ema = {}
    for name, p in params.items():
        state = {"m": torch.zeros(p.shape, dtype=mdtype, device=p.device)}
        if _is_factored(p, cfg):
            state["vr"] = torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device)
            state["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)
        else:
            state["v"] = torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
        ema[name] = state
    device = next(iter(params.values())).device if params else None
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "ema": ema}


_NO_DECAY = ("scale", "bias", "b1", "b2", "bq", "bk", "bv", "gn_scale",
             "b_if", "b_gates", "lam", "pos")


def _no_decay(name: str) -> bool:
    return name.endswith(_NO_DECAY)


@torch.no_grad()
@scope("adamw")
def adamw_update(params: dict, grads: dict, state: dict, cfg: OptConfig,
                 specs=None, mesh=None):
    """Returns (new_params, new_state, metrics {"lr", "grad_norm"}).
    ``specs`` ({name: spec}) and ``mesh``: the leaves are blocks over the
    mesh (see the module's docstring)."""
    step = state["step"] + 1
    stepf = step.float()
    lr = cosine_schedule(cfg, stepf)
    gnorm = global_norm(grads, specs, mesh)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    bc1 = 1.0 - torch.pow(cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(cfg.b2, stepf)
    new_params, new_ema = {}, {}
    for name, p in params.items():
        s = state["ema"][name]
        g = grads[name].float() * scale
        m = s["m"].float() * cfg.b1 + g * (1 - cfg.b1)
        if "v" in s:
            v = s["v"] * cfg.b2 + torch.square(g) * (1 - cfg.b2)
            denom = torch.sqrt(v / bc2) + cfg.eps
            new_s = {"m": m.to(s["m"].dtype), "v": v}
        else:
            spec = (None, None) if specs is None else specs[name]
            g2 = torch.square(g) + 1e-30
            vr = s["vr"] * cfg.b2 + _mean(g2, -1, spec[-1], mesh) \
                * (1 - cfg.b2)
            vc = s["vc"] * cfg.b2 + _mean(g2, -2, spec[-2], mesh) \
                * (1 - cfg.b2)
            # rank-1 reconstruction: v ~= vr vc / mean(vr)
            vhat = (vr[..., None] * vc[..., None, :]
                    / torch.clamp_min(_mean(vr, -1, spec[-2], mesh,
                                            keepdim=True)[..., None],
                                      1e-30))
            denom = torch.sqrt(vhat / bc2) + cfg.eps
            new_s = {"m": m.to(s["m"].dtype), "vr": vr, "vc": vc}
        update = (m / bc1) / denom
        if cfg.weight_decay and not _no_decay(name):
            update = update + cfg.weight_decay * p.float()
        new_params[name] = (p.float() - lr * update).to(p.dtype)
        new_ema[name] = new_s
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_params, {"step": step, "ema": new_ema}, metrics
