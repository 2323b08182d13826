"""xLSTM blocks: mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar,
strictly recurrent), the port of ``repro.models.xlstm``.  [arXiv:2405.04517]

mLSTM recurrence per head (state C in R^{dh x dh}, n in R^dh, stabilizer m):

    m_t = max(logf_t + m_{t-1}, logi_t)                  # running-max rescale
    C_t = exp(logf_t + m_{t-1} - m_t) C_{t-1} + exp(logi_t - m_t) v_t k_t^T
    n_t = exp(logf_t + m_{t-1} - m_t) n_{t-1} + exp(logi_t - m_t) k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

Prefill uses the chunkwise form (intra-chunk quadratic + the carried
inter-chunk state; a Python loop over the chunks where the reference runs
``lax.scan``), decode the one-token recurrence.  The sLSTM scan is a Python
loop over the sequence.  The states are float32, the −1e30 sentinels and
the padding rule (padded steps get ``logi = −1e30``, ``logf = 0``) are the
reference's.

Where the reference returns a new state, these functions write it into the
state tensors they were given (``copy_``) and return them, as the port
does for KV caches.  Every projection goes through ``unified_linear``; the
float32 products and reductions of the recurrences run through
:func:`seq_groups`, so on the card a sequence's bits do not depend on how
many sequences share the call.

Tensor parallelism (a ``model`` axis of ``tp`` > 1 that divides the
heads, :func:`split_over`): past its projections each block works per
head, so a rank runs the recurrences on its ``H / tp`` heads, with a
state of those heads, as the reference's table splits the widths.  The
mLSTM: the input through the Megatron ``f`` (``spmd.model_input``), its
columns of ``w_up``, ``w_gates`` (its heads' channels: ``hn`` is
head-major) and ``conv``, summed in the whole weight's order
(``order_n``); the conv output gathered whole over ``model``, the
table's contiguous block of ``w_qkv``'s columns, the product gathered
whole and the rank's heads of q, k and v taken from it; the whole
``w_if``/``b_if``/``gn_scale`` read for its heads alone; its rows of
``w_down`` giving float32 partials added over ``model`` before the one
rounding.  The sLSTM: its heads' columns of ``w_gates`` (the reshape to
(H, dh, 4) is head-major) and of ``r_gates``, the group-normed output
gathered whole, then the up-projection whole on every rank, or split as
the dense MLP is where ``tp`` divides its ``4d/3`` columns.  A whole leaf
a rank reads only in part passes through the ``f`` itself, so its
gradient is the ranks' sum; a gathered tensor that feeds split work
passes through it after the gather (the gather's backward takes the
rank's block of a gradient every rank holds whole).
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
from repro_torch.roofline.op_cost import repeat
from repro_torch.roofline.scope import scope

__all__ = ["group_norm", "causal_conv1d", "seq_groups", "init_mlstm",
           "apply_mlstm", "init_mlstm_state", "mlstm_recurrent_step",
           "init_slstm", "apply_slstm", "init_slstm_state", "split_over",
           "SEQ_GROUP"]

NEG = -1e30
# On the card a float32 product or reduction picks its algorithm (and so
# its order of summation) from its shape, the number of rows included.
# The recurrences' float32 work therefore runs over groups of exactly
# SEQ_GROUP sequences, the last padded with zero rows, so a sequence gets
# the same bits alone, in a batch of 8 or in a scheduler slot.
SEQ_GROUP = 8


def _grouped(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return None if tree is None else fn(tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


def seq_groups(fn, *args):
    """``fn(*args)``, where every tensor of ``args`` (nested in tuples;
    None passes through) has the batch on dim 0 and ``fn`` treats the
    sequences independently.  On the card ``fn`` runs over groups of
    exactly :data:`SEQ_GROUP` sequences, zero-padded, and the outputs
    (a tensor or nested tuples) are joined and cut back to the batch."""
    first = _leaves(args)[0]
    if not _grouped(first):
        return fn(*args)
    b = first.shape[0]
    n = -(-b // SEQ_GROUP) * SEQ_GROUP

    def pad(t):
        return torch.cat([t, t.new_zeros((n - b,) + t.shape[1:])]) \
            if n != b else t

    padded = _map(pad, args)
    outs = [fn(*_map(lambda t, g=g: t[g:g + SEQ_GROUP], padded))
            for g in range(0, n, SEQ_GROUP)]

    def join(*parts):
        if isinstance(parts[0], (tuple, list)):
            return type(parts[0])(join(*p) for p in zip(*parts))
        return torch.cat(parts)[:b]

    return join(*outs)


# ------------------------------------------------------------ helpers


def group_norm(x, scale, eps=1e-6):
    """Per-head layernorm (no bias): x (..., H, dh), scale (H, dh)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale).to(x.dtype)


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv: x (B, S, D), w (cw, D), state (B, cw-1, D) or
    None.  Returns (y, new_state), new_state holding the trailing cw-1
    inputs; y float32 sums of the taps in order, in x's dtype."""
    cw = w.shape[0]
    b, s, d = x.shape
    if state is None:
        state = x.new_zeros((b, cw - 1, d))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(cw):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(cw - 1):] if cw > 1 else state
    return y.to(x.dtype), new_state


def _div_in_dtype(t, c: float):
    """``t / c`` with ``c`` rounded to t's dtype first, as the reference's
    weakly typed scalar is."""
    return t / torch.tensor(c, dtype=t.dtype).item()


def _write(state: dict, new: dict) -> dict:
    """Copy ``new`` into the caller's state tensors (in place); without a
    state, ``new`` itself."""
    if state is None:
        return new
    for k, v in new.items():
        state[k].copy_(v)
    return state


def split_over(cfg: ArchConfig, tp: int) -> bool:
    """Whether the mLSTM and sLSTM blocks split over a ``model`` axis of
    ``tp``: where ``tp`` divides the heads (then it also divides the
    widths ``2d``, ``3 * 2d`` and ``4d`` the reference's table splits).
    Otherwise every mixer leaf stays whole."""
    return tp > 1 and cfg.num_heads % tp == 0


def _rank_heads(nh: int, h: int) -> int:
    """The first of this rank's ``nh`` heads of ``h`` (0 where it holds
    them all)."""
    return 0 if nh == h else spmd.model_rank() * nh


# ------------------------------------------------------------ mLSTM


def init_mlstm(rng: np.random.Generator, cfg: ArchConfig, dtype):
    d, h = cfg.d_model, cfg.num_heads
    di = 2 * d  # pf = 2
    s, si = 1.0 / math.sqrt(d), 1.0 / math.sqrt(di)
    f32 = torch.float32
    return {
        "w_up": normal(rng, (d, di), s, dtype),
        "w_gates": normal(rng, (d, di), s, dtype),   # z branch
        "w_qkv": normal(rng, (di, 3 * di), si, dtype),
        "conv": normal(rng, (cfg.conv_width, di), 0.1, f32),
        "w_if": normal(rng, (di, 2 * h), si, f32),
        "b_if": torch.cat([torch.zeros((h,)), torch.full((h,), 3.0)]),
        "gn_scale": torch.ones((h, di // h), dtype=f32),
        "w_down": normal(rng, (di, d), si, dtype),
    }


def _mlstm_chunk_scan(q, k, v, logi, logf, state, chunk: int):
    """Chunkwise mLSTM.  q, k, v: (B, H, S, dh); logi/logf: (B, H, S)
    float32; state: (C (B, H, dh, dh), n (B, H, dh), m (B, H)) or None.
    Returns (h (B, H, S, dh) in q's dtype, new_state)."""
    b, h, s, dh = q.shape
    nchunk = -(-s // chunk)
    pad = nchunk * chunk - s
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        logi = F.pad(logi, (0, pad), value=NEG)  # exp(-inf) = 0
        logf = F.pad(logf, (0, pad), value=0.0)  # no decay of the state
    qc = q.reshape(b, h, nchunk, chunk, dh).float()
    kc = _div_in_dtype(k.reshape(b, h, nchunk, chunk, dh),
                       math.sqrt(dh)).float()
    vc = v.reshape(b, h, nchunk, chunk, dh).float()
    lic = logi.reshape(b, h, nchunk, chunk)
    lfc = logf.reshape(b, h, nchunk, chunk)
    if state is None:
        C = q.new_zeros((b, h, dh, dh), dtype=torch.float32)
        n = q.new_zeros((b, h, dh), dtype=torch.float32)
        m = torch.full((b, h), NEG, dtype=torch.float32, device=q.device)
    else:
        C, n, m = state
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    outs = []
    # the dry-run on meta counts one chunk nchunk times (op_cost.repeat)
    with repeat(nchunk, q.device) as rep:
        qc, kc, vc, lic, lfc, C, n, m = rep.begin(qc, kc, vc, lic, lfc,
                                                  C, n, m, each=5)
        for c in range(rep.steps):
            qb, kb, vb = qc[:, :, c], kc[:, :, c], vc[:, :, c]
            li, lf = lic[:, :, c], lfc[:, :, c]
            bcum = torch.cumsum(lf, dim=-1)        # b_i = sum_{s<=i} logf
            # stabilizer: m_i = b_i + max(m_prev, running max_{j<=i}
            # (li_j - b_j))
            run = torch.cummax(li - bcum, dim=-1).values
            m_i = bcum + torch.maximum(m[..., None], run)
            # intra-chunk decay: log w_ij = b_i - b_j + li_j  (j <= i)
            logw = bcum[..., :, None] - bcum[..., None, :] + li[..., None, :]
            logw = torch.where(tri, logw - m_i[..., :, None], NEG)
            sc = torch.einsum("bhid,bhjd->bhij", qb, kb) * torch.exp(logw)
            num_intra = torch.einsum("bhij,bhjd->bhid", sc, vb)
            den_intra = sc.sum(-1)
            # inter-chunk: the carried state at scale m_prev
            inter_scale = torch.exp(bcum + m[..., None] - m_i)
            num_inter = torch.einsum("bhid,bhde->bhie", qb, C)
            den_inter = torch.einsum("bhid,bhd->bhi", qb, n)
            num = num_intra + num_inter * inter_scale[..., None]
            den = den_intra + den_inter * inter_scale
            outs.append(num / torch.maximum(den.abs(),
                                            torch.exp(-m_i))[..., None])
            # the state at the end of the chunk
            m_l = m_i[..., -1]
            carry = torch.exp(bcum[..., -1:] + m[..., None] - m_l[..., None])
            kv_scale = torch.exp(bcum[..., -1:] - bcum + li - m_l[..., None])
            C = C * carry[..., None] + torch.einsum("bhj,bhjd,bhje->bhde",
                                                    kv_scale, kb, vb)
            n = n * carry + torch.einsum("bhj,bhjd->bhd", kv_scale, kb)
            m = m_l
    hseq, C, n, m = rep.end(rep.stack(outs, dim=2), C, n, m)
    hseq = hseq.reshape(b, h, nchunk * chunk, dh)
    return hseq[:, :, :s].to(q.dtype), (C, n, m)


def mlstm_recurrent_step(q, k, v, logi, logf, state):
    """One-token recurrence.  q, k, v: (B, H, dh); logi/logf: (B, H);
    state as in :func:`_mlstm_chunk_scan`.  Returns (h float32, state)."""
    C, n, m = state
    dh = q.shape[-1]
    k = k.float() / math.sqrt(dh)
    v, q = v.float(), q.float()
    m_new = torch.maximum(logf + m, logi)
    fscale = torch.exp(logf + m - m_new)
    iscale = torch.exp(logi - m_new)
    C = C * fscale[..., None, None] + iscale[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = n * fscale[..., None] + iscale[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.einsum("bhd,bhd->bh", q, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, (C, n, m_new)


def _mlstm_core(params, cfg: ArchConfig, decode: bool, lo: int, uc, qkv,
                z, C, n, m):
    """The float32 part of an mLSTM block, per sequence: the scalar gates,
    the recurrence, the group norm and the z gate, on the heads ``lo`` ..
    ``lo + nh`` that ``z``'s ``nh * dh`` channels hold (all of them on one
    device; a rank's under tensor parallelism, ``uc`` and ``qkv`` whole).
    Returns (gated in uc's dtype, (C, n, m))."""
    b, s, di = uc.shape
    h = cfg.num_heads
    dh = di // h
    nh = z.shape[-1] // dh
    heads = slice(lo, lo + nh)
    gates = torch.matmul(uc.float(), params["w_if"]) + params["b_if"]
    logi, logf_raw = torch.chunk(gates, 2, dim=-1)          # (B, S, H)
    logi, logf = logi[..., heads], F.logsigmoid(logf_raw[..., heads])

    def split(t):  # (B, S, di) -> the heads' (B, nh, S, dh)
        return t.reshape(b, s, h, dh)[:, :, heads].transpose(1, 2)

    q, k, v = (split(t) for t in torch.chunk(qkv, 3, dim=-1))
    logi_t, logf_t = logi.transpose(1, 2), logf.transpose(1, 2)
    inner = None if C is None else (C, n, m)
    if decode and s == 1:   # a decode step always carries a state
        hout, inner = mlstm_recurrent_step(
            q[:, :, 0], k[:, :, 0], v[:, :, 0], logi_t[:, :, 0],
            logf_t[:, :, 0], inner)
        hout = hout[:, :, None, :]
    else:
        hout, inner = _mlstm_chunk_scan(q, k, v, logi_t, logf_t, inner,
                                        cfg.mlstm_chunk)
    hn = group_norm(hout.transpose(1, 2), params["gn_scale"][heads])
    hn = hn.reshape(b, s, nh * dh)                          # (B, S, nh dh)
    gated = hn * F.silu(z.float()).to(hn.dtype)
    return gated.to(uc.dtype), inner


@scope("mlstm")
def apply_mlstm(params, x, cfg: ArchConfig, state=None, decode=False):
    """x: (B, S, d).  state: {"C", "n", "m", "conv"} or None, updated in
    place: a rank's heads and conv channels where ``params`` hold its
    blocks (``w_gates`` narrower than ``2d``: see the module's
    docstring).  Returns (y, state)."""
    di = 2 * cfg.d_model
    split = params["w_gates"].shape[-1] != di
    if split:
        x_in = spmd.model_input(x, "mlstm input")
        params = dict(params)
        for name in ("w_if", "b_if", "gn_scale"):
            params[name] = spmd.model_input(params[name],
                                            "mlstm whole leaves")
    else:
        x_in = x
    order = di if split else None
    u = constrain(unified_linear(x_in, params["w_up"], order_n=order),
                  "btw")
    z = unified_linear(x_in, params["w_gates"], order_n=order)
    conv_state = state["conv"] if state is not None else None
    uc, conv_state = causal_conv1d(u, params["conv"], conv_state)
    uc = F.silu(uc.float()).to(u.dtype)
    if split:
        # the conv and SiLU work per channel: the rank's channels gathered
        # are the whole uc; its block of w_qkv's columns, the product
        # gathered whole
        uc = spmd.model_input(spmd.model_gather(uc, "mlstm_uc all-gather"),
                              "mlstm_uc input")
        qkv = unified_linear(uc, params["w_qkv"], order_n=3 * di)
        qkv = spmd.model_input(spmd.model_gather(qkv,
                                                 "mlstm_qkv all-gather"),
                               "mlstm_qkv input")
    else:
        qkv = unified_linear(uc, params["w_qkv"])
    lo = _rank_heads(z.shape[-1] * cfg.num_heads // di, cfg.num_heads)
    cnm = (None,) * 3 if state is None else (state["C"], state["n"],
                                             state["m"])
    gated, (C, n, m) = seq_groups(
        lambda *a: _mlstm_core(params, cfg, decode, lo, *a), uc, qkv, z,
        *cnm)
    if split:
        # a row block of w_down: float32 partials, added over the ranks,
        # then the one rounding
        y = unified_linear(gated.to(x.dtype), params["w_down"],
                           out_dtype=torch.float32)
        y = spmd.model_sum(y, "mlstm_down all-reduce").to(x.dtype)
    else:
        y = unified_linear(gated.to(x.dtype), params["w_down"])
    return constrain(y, "btd"), _write(state, {"C": C, "n": n, "m": m,
                                               "conv": conv_state})


def init_mlstm_state(cfg: ArchConfig, batch: int, device=None,
                     heads: int | None = None):
    """A zeroed state of ``heads`` heads and their conv channels (default:
    all of them; a rank's under tensor parallelism)."""
    h = heads or cfg.num_heads
    dh = 2 * cfg.d_model // cfg.num_heads
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
        "m": torch.full((batch, h), NEG, dtype=f32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, h * dh),
                            dtype=cfg.activation_dtype, device=device),
    }


# ------------------------------------------------------------ sLSTM


def init_slstm(rng: np.random.Generator, cfg: ArchConfig, dtype):
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    dup = (4 * d) // 3
    s = 1.0 / math.sqrt(d)
    f32 = torch.float32
    return {
        "w_gates": normal(rng, (d, 4 * d), s, dtype),
        "b_gates": torch.cat([torch.zeros((d,)), torch.full((d,), 3.0),
                              torch.zeros((2 * d,))]),
        "r_gates": normal(rng, (h, dh, 4 * dh), 1.0 / math.sqrt(dh), f32),
        "gn_scale": torch.ones((h, dh), dtype=f32),
        "w_up": normal(rng, (d, dup), s, dtype),
        "w_up2": normal(rng, (d, dup), s, dtype),
        "w_down": normal(rng, (dup, d), 1.0 / math.sqrt(dup), dtype),
    }


def _slstm_cell(wx, r_gates, state):
    """One step.  wx: (B, H, dh, 4), W x_t + b; state (c, n, h, m)."""
    c, n, hprev, m = state
    b_, h_, dh = hprev.shape
    rec = torch.einsum("bhd,hdg->bhg", hprev, r_gates).reshape(b_, h_, dh, 4)
    pre = wx + rec
    z = torch.tanh(pre[..., 0])
    i_, f_ = pre[..., 1], pre[..., 2]
    o = torch.sigmoid(pre[..., 3])
    logf = F.logsigmoid(f_)
    m_new = torch.maximum(logf + m, i_)
    fscale = torch.exp(logf + m - m_new)
    iscale = torch.exp(i_ - m_new)
    c = fscale * c + iscale * z
    n = fscale * n + iscale
    hnew = o * c / torch.clamp_min(n, 1e-6)
    return (c, n, hnew, m_new), hnew


def _slstm_core(params, cfg: ArchConfig, x, c, n, hp, m):
    """The float32 part of an sLSTM block, per sequence: the gate product,
    the sequential scan and the group norm, on the heads whose recurrent
    weights ``params["r_gates"]`` holds (all of them on one device; a
    rank's under tensor parallelism, with its columns of ``w_gates`` and
    ``b_gates``).  Returns (hn in x's dtype, (c, n, h, m))."""
    b, s, d = x.shape
    h, dh = params["r_gates"].shape[0], d // cfg.num_heads
    wx = torch.matmul(x.float(), params["w_gates"].float()) \
        + params["b_gates"]
    wx = wx.reshape(b, s, h, dh, 4)
    if c is None:
        zero = x.new_zeros((b, h, dh), dtype=torch.float32)
        inner = (zero, zero, zero, torch.full_like(zero, NEG))
    else:
        inner = (c, n, hp, m)
    hs = []
    # decode (S == 1) is the same one step; the dry-run on meta counts one
    # step s times (op_cost.repeat)
    with repeat(s, x.device) as rep:
        wx, r_gates, *inner = rep.begin(wx, params["r_gates"], *inner,
                                        each=2)
        for t in range(rep.steps):
            inner, ht = _slstm_cell(wx[:, t], r_gates, inner)
            hs.append(ht)
    hseq, *inner = rep.end(rep.stack(hs, dim=1), *inner)     # (B,S,H,dh)
    hn = group_norm(hseq, params["gn_scale"]).reshape(b, s, h * dh)
    return hn.to(x.dtype), tuple(inner)


@scope("slstm")
def apply_slstm(params, x, cfg: ArchConfig, state=None, decode=False):
    """x: (B, S, d).  Strictly sequential scan (the recurrent h feeds the
    gates).  state: {"c", "n", "h", "m"} or None, updated in place: a
    rank's heads where ``params`` hold its blocks (``r_gates`` of fewer
    heads than the config's: see the module's docstring)."""
    d = cfg.d_model
    nh = params["r_gates"].shape[0]
    split = nh != cfg.num_heads
    core = params
    if split:
        # the rank's heads: its columns of w_gates, those of the whole
        # b_gates and its rows of the whole gn_scale
        lo = _rank_heads(nh, cfg.num_heads)
        cols = slice(lo * 4 * d // cfg.num_heads,
                     (lo + nh) * 4 * d // cfg.num_heads)
        core = dict(params,
                    b_gates=spmd.model_input(params["b_gates"],
                                             "slstm whole leaves")[cols],
                    gn_scale=spmd.model_input(params["gn_scale"],
                                              "slstm whole leaves")[
                        lo:lo + nh])
        x_in = spmd.model_input(x, "slstm input")
    else:
        x_in = x
    cnhm = (None,) * 4 if state is None else tuple(
        state[k] for k in ("c", "n", "h", "m"))
    hn, (c, n, hp, m) = seq_groups(
        lambda *a: _slstm_core(core, cfg, *a), x_in, *cnhm)
    if split:
        hn = spmd.model_gather(hn, "slstm_hn all-gather")
    dup = (4 * d) // 3
    if params["w_up"].shape[-1] != dup:
        # the up-projection's columns on this rank (the dense MLP's split)
        hn = spmd.model_input(hn, "slstm_up input")
        up = unified_linear(hn, params["w_up"], activation="gelu",
                            order_n=dup)
        up2 = unified_linear(hn, params["w_up2"], order_n=dup)
        y = unified_linear((up * up2).to(x.dtype), params["w_down"],
                           out_dtype=torch.float32)
        y = spmd.model_sum(y, "slstm_down all-reduce").to(x.dtype)
    else:
        # whole on every rank, from the whole hn: its gradient is each
        # rank's whole one, of which the gather's backward takes the block
        up = unified_linear(hn, params["w_up"], activation="gelu")
        up2 = unified_linear(hn, params["w_up2"])
        y = unified_linear((up * up2).to(x.dtype), params["w_down"])
    return constrain(y, "btd"), _write(state, {"c": c, "n": n, "h": hp,
                                               "m": m})


def init_slstm_state(cfg: ArchConfig, batch: int, device=None,
                     heads: int | None = None):
    """A zeroed state of ``heads`` heads (default: all of them; a rank's
    under tensor parallelism)."""
    h = heads or cfg.num_heads
    dh = cfg.d_model // cfg.num_heads

    def zero():
        return torch.zeros((batch, h, dh), dtype=torch.float32,
                           device=device)

    return {"c": zero(), "n": zero(), "h": zero(),
            "m": torch.full((batch, h, dh), NEG, dtype=torch.float32,
                            device=device)}
