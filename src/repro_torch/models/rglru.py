"""RG-LRU recurrent block (Griffin / RecurrentGemma), the port of
``repro.models.rglru``.  [arXiv:2402.19427]

Real-Gated Linear Recurrent Unit, per channel:

    r_t = sigmoid(block_diag_linear_r(x_t))          # recurrence gate
    i_t = sigmoid(block_diag_linear_i(x_t))          # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)           # c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is linear, so prefill scans it in log depth: where the
reference runs ``lax.associative_scan``, :func:`_rglru_scan` doubles the
reach of a Hillis–Steele scan each pass (12 elementwise passes at 2304
tokens, not a launch per token); decode is one step.  The gate
projections are block-diagonal with ``num_heads`` blocks; they are the
block's one float32 product and run through ``xlstm.seq_groups``.

Block structure (the Griffin "recurrent block"):
    x -> W_x -> causal conv1d(4) -> RG-LRU ┐
    x -> W_y -> GeLU ──────────────────────┴─ elementwise * -> W_down

Tensor parallelism (a ``model`` axis larger than one, :func:`split_over`):
past its projections the block works per channel (the depthwise conv,
``lam``, the scan and the decode step) or per head block (the gates), so
a rank holding a block of the width ``W`` — its columns of ``w_up``,
``w_up2``, ``conv`` and ``lam``, its heads of ``gates``, its rows of
``w_down`` — runs the whole recurrence on its own channels, with a
recurrent state of its own width.  As the split MLP in
``models/layers.py``: the input through the Megatron ``f``
(``spmd.model_input``), the column blocks summed in the whole weight's
order (``order_n``), the row block's float32 partials added over
``model`` (``spmd.model_sum``) before the one rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.moe import normal
from repro_torch.core.unified_linear import unified_linear
from repro_torch.dist import spmd
from repro_torch.dist.sharding import constrain
from repro_torch.models.xlstm import _write, causal_conv1d, seq_groups
from repro_torch.roofline.scope import scope

__all__ = ["init_rglru", "apply_rglru", "init_rglru_state", "rglru_step",
           "split_over", "C_SCALE"]

C_SCALE = 8.0


def init_rglru(rng, cfg: ArchConfig, dtype):
    """The reference's shapes and scales; ``rng`` a NumPy generator (on the
    CPU) or a ``torch.Generator`` (on its device)."""
    d = cfg.d_model
    w = cfg.lru_width or d
    h = cfg.num_heads
    bw = w // h
    s, sb = 1.0 / math.sqrt(d), 1.0 / math.sqrt(bw)
    f32 = torch.float32
    p = {"w_up": normal(rng, (d, w), s, dtype),          # x branch
         "w_up2": normal(rng, (d, w), s, dtype),         # y branch
         "conv": normal(rng, (cfg.conv_width, w), 0.1, f32),
         "gates": normal(rng, (h, bw, 2 * bw), sb, f32)}
    # Lambda so that a = exp(-c * softplus(Lambda)) spreads over (0.9, 0.999)
    if isinstance(rng, torch.device):       # shapes only
        u = torch.full((w,), 0.95, device=rng)
    elif isinstance(rng, torch.Generator):
        u = torch.rand((w,), generator=rng, device=rng.device) * 0.099 + 0.9
    else:
        u = torch.from_numpy(rng.uniform(0.9, 0.999, size=(w,)).astype(
            np.float32))
    p["lam"] = torch.log(torch.expm1(-torch.log(u) / C_SCALE))
    p["w_down"] = normal(rng, (w, d), 1.0 / math.sqrt(w), dtype)
    return p


def _coeffs(r, lam):
    """(a, sqrt(1 - a^2)) from the recurrence gate, with expm1 for
    precision near a ~ 1."""
    log_a = -C_SCALE * F.softplus(lam) * r
    return torch.exp(log_a), torch.sqrt(-torch.expm1(2.0 * log_a))


def _shift(t, d: int, fill: float):
    """t (B, S, W) moved d steps later along S, the first d filled."""
    return F.pad(t[:, :-d], (0, 0, d, 0), value=fill)


def _rglru_scan(x, r, i, lam, h0=None):
    """x, r, i: (B, S, W) float32; h0 (B, W) or None.  h for every step:
    the pairs (a, u) combined as (a1 a2, a2 b1 + b2), reach doubling each
    pass.  ``h0`` is folded in as a virtual step 0 (a_0 = 1)."""
    a, beta = _coeffs(r, lam)
    u = beta * (i * x)
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        u = torch.cat([h0[:, None, :], u], dim=1)
    d = 1
    while d < a.shape[1]:
        u = a * _shift(u, d, 0.0) + u
        a = a * _shift(a, d, 1.0)
        d *= 2
    return u[:, 1:] if h0 is not None else u


def rglru_step(x, r, i, lam, h_prev):
    """One decode step: x, r, i (B, W); h_prev (B, W)."""
    a, beta = _coeffs(r, lam)
    return a * h_prev + beta * (i * x)


def _gates(xc32, gates):
    """The block-diagonal gate projection, sigmoid: (r, i), each (B, S,
    W)."""
    b, s, w = xc32.shape
    h, bw = gates.shape[0], gates.shape[1]
    g = torch.einsum("bshi,hig->bshg", xc32.reshape(b, s, h, bw), gates)
    r, i = torch.chunk(torch.sigmoid(g), 2, dim=-1)
    return r.reshape(b, s, w), i.reshape(b, s, w)


def split_over(cfg: ArchConfig, tp: int) -> bool:
    """Whether the block splits its width over a ``model`` axis of
    ``tp``: where ``tp`` divides both the width and the gates' head count
    (the reference's table splits both; a split width beside whole gates
    has no consistent block).  Otherwise every leaf stays whole."""
    w = cfg.lru_width or cfg.d_model
    return tp > 1 and w % tp == 0 and cfg.num_heads % tp == 0


@scope("rglru")
def apply_rglru(params, x, cfg: ArchConfig, state=None, decode=False):
    """x: (B, S, d) -> (y, state).  state: {"h": (B, W), "conv": (B,
    cw-1, W)} or None, updated in place; a rank's block of the width
    where ``params`` hold a block of it (``W / tp``: see the module's
    docstring)."""
    w = cfg.lru_width or cfg.d_model
    split = params["w_up"].shape[-1] != w
    order = w if split else None
    xin = spmd.model_input(x, "rglru input") if split else x
    xb = constrain(unified_linear(xin, params["w_up"], order_n=order),
                   "btw")
    yb = unified_linear(xin, params["w_up2"], activation="gelu",
                        order_n=order)
    conv_state = state["conv"] if state is not None else None
    xc, conv_state = causal_conv1d(xb, params["conv"], conv_state)
    xc32 = xc.float()
    r, i = seq_groups(lambda t: _gates(t, params["gates"]), xc32)
    h_prev = state["h"] if state is not None else None
    if decode and x.shape[1] == 1:
        if h_prev is None:
            h_prev = xc32.new_zeros(xc32[:, 0].shape)
        hseq = rglru_step(xc32[:, 0], r[:, 0], i[:, 0], params["lam"],
                          h_prev)[:, None]
    else:
        hseq = _rglru_scan(xc32, r, i, params["lam"], h_prev)
    out = hseq.to(x.dtype) * yb
    if split:
        # a row block of w_down: float32 partials, added over the ranks,
        # then the one rounding
        y = unified_linear(out, params["w_down"], out_dtype=torch.float32)
        y = spmd.model_sum(y, "rglru_down all-reduce").to(x.dtype)
    else:
        y = unified_linear(out, params["w_down"])
    return constrain(y, "btd"), _write(state, {"h": hseq[:, -1],
                                               "conv": conv_state})


def init_rglru_state(cfg: ArchConfig, batch: int, device=None,
                     width: int | None = None):
    """A zeroed state of ``width`` channels (default: the whole width; a
    rank's block under tensor parallelism)."""
    w = width or cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=cfg.activation_dtype, device=device),
    }
