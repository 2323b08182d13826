"""moe_fused: the whole routed expert layer in one kernel pass — gather by
token index, expert MLP, gate-weighted combine (Edge-MoE §IV-D end to end).

Replaces the Pallas kernel ``src/repro/kernels/moe_fused.py``
(``fused_moe_kernel`` / ``fused_moe_call``, reached through
``kernels/ops.py:fused_moe_ffn`` and the ``moe_ffn``/``pallas_fused``
impl).  CUDA source: ``csrc/moe_fused.cu``.

What bounds it on the H100: an M³ViT MoE layer at B = 8 (8 routing groups
of 128 tokens, 16 experts, top-4, d 192, f 768) is ~2.4 GFLOP over ~10 MB
(x, the used experts' weights, the slot scratch, out), so the bytes set
the least time (~3 µs); with ~70 tiles of 64 rows for 132 SMs, what a
launch costs is one block's latency.  The design keeps the TPU kernel's
contracts — no (E, C, d) dispatch buffer and no (rows, f) hidden in device
memory, routing read on the card, empty queues and tiles past a queue's
end returning before the expert's weights are read, dead slots adding
nothing — and runs in one of two variants, chosen by
:func:`repro_torch.kernels.gemm_plan.plan_moe_fused` and counted apart in
``fused_moe_ffn.variants``:

* ``tc`` (bf16, 16-byte rows, d <= 768): each block packs 64 of one
  expert's live queue rows, taken from every routing group in turn,
  gathers their x rows by token index (``cp.async``), streams the expert's
  weights by TMA through an ``mbarrier`` ring one 64-wide chunk of f at a
  time, and for each chunk computes ``h = act(x·w1 + b1)`` by ``wgmma`` in
  float32 registers and ``y += h·w2`` by ``wgmma`` with h as the register
  operand, as a bf16 pair ``hi + lo`` (one bf16 h leaves the tolerance at
  M³ViT's shape: ``tests/test_torch_moe_numerics.py``).  Two warpgroups
  take the chunks in turn and add their partial y once, in shared memory.
* ``simt`` (float32, unaligned bf16, what tc's shared memory cannot hold):
  32 queue rows of one (group, expert) a block, the hidden walked in chunks
  of 64 on the float32 FMA pipes.

A short first launch builds the queues by reference on the card (the
arrays of :func:`build_queues`).  Both variants write each live row's
``gate · (y + b2)`` to a float32 slot scratch (G, T, k, d), and a short
last launch sums each token's valid slots in ascending expert index — the
order the sequential TPU grid adds them in, with no float atomics — and
casts once to ``x.dtype``.  A row's sums run in the same order whatever
the number of routing groups (f is never split over blocks), so a frame's
output does not depend on its batch.  The three launches count as one
``moe_fused`` launch.

The public :func:`fused_moe_ffn` keeps a leading group axis, x (G, T, d),
so one MoE layer is one kernel pass over every routing group (the reference
``vmap``s it per group).  It runs :func:`fused_moe_ffn_plain` for CPU
tensors and launches the planned variant for CUDA tensors, or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.gelu import (device_table, exact_gelu, exact_silu,
                                   lut_correction)
from repro_torch.kernels import build, gemm_plan

__all__ = ["fused_moe_ffn", "fused_moe_ffn_plain", "build_queues",
           "plan_for", "MAX_D", "MAX_K"]

# d both variants take: simt keeps two (32, d) float32 tiles and the table
# in its 216 KB of shared memory; tc the (64, d) bf16 x tile and one ring
# stage (GELU: d 768 at one stage; SwiGLU's two first-product matrices stop
# tc below that, gemm_plan.plan_moe_fused)
MAX_D = 768
MAX_K = 8            # csrc/moe_fused.cu:kMaxK (the combine's slot order)
KINDS = {"gelu": 0, "swiglu": 1}     # csrc/moe_fused.cu:Kind
_EXPERT_NAMES = {"gelu": ("w1", "b1", "w2", "b2"),
                 "swiglu": ("wg", "wu", "wd")}


def build_queues(expert, gate, position, valid, num_experts: int,
                 capacity: int):
    """Per-expert queues by reference (Fig. 9d), the construction of the
    reference's ``kernels/ops.py:fused_moe_ffn``: routing fields (G, T, k)
    -> ``tok_idx`` (G, E, C) int32 with −1 in dead slots, ``gates``
    (G, E, C) float32 with 0 in dead slots, and ``slot_idx`` (G, E, C)
    int32, the routing slot (0..k−1) of each live entry, −1 in dead ones.
    Capacity drops write a scrap column at index C, sliced off."""
    g, t, k = expert.shape
    dev = expert.device
    e = expert.reshape(g, t * k).long()
    v = valid.reshape(g, t * k)
    p_safe = torch.where(v, position.reshape(g, t * k).long(), capacity)
    gv = gate.reshape(g, t * k).float() * v.float()
    gi = torch.arange(g, device=dev)[:, None].expand(g, t * k)
    tok = torch.arange(t, device=dev, dtype=torch.int32)[:, None].expand(
        t, k).reshape(-1)
    slot = torch.arange(k, device=dev, dtype=torch.int32).repeat(t)
    shape = (g, num_experts, capacity + 1)
    tok_idx = torch.full(shape, -1, dtype=torch.int32, device=dev)
    slot_idx = torch.full(shape, -1, dtype=torch.int32, device=dev)
    gates = torch.zeros(shape, dtype=torch.float32, device=dev)
    tok_idx[gi, e, p_safe] = tok.expand(g, t * k)
    slot_idx[gi, e, p_safe] = slot.expand(g, t * k)
    gates[gi, e, p_safe] = gv
    return (tok_idx[..., :capacity], gates[..., :capacity],
            slot_idx[..., :capacity])


def _weights(params, kind):
    return tuple(params[n] for n in _EXPERT_NAMES[kind])


def _activate(h, kind, use_lut, table, step_log2):
    if use_lut:
        return lut_correction(h, table, step_log2)
    return exact_silu(h) if kind == "swiglu" else exact_gelu(h)


def fused_moe_ffn_plain(x, params, expert, gate, position, valid,
                        group_sizes, *, kind, capacity, use_lut=True,
                        step_log2=-8, lut_range=8.0):
    """The kernel's arithmetic in plain PyTorch: every queue row gathered
    in float32, ``h = act(xq @ w1 + b1)`` (or ``act(xq @ wg) · (xq @ wu)``)
    and ``y = h @ w2 + b2`` in float32, each live row's ``gate · y`` put at
    its (token, slot), and each token's valid slots summed from 0 in
    ascending expert index, then one cast to ``x.dtype``.  ``group_sizes``
    is implied by the queues and not read here."""
    g, t, d = x.shape
    k = expert.shape[-1]
    e_num = (params["wg"] if kind == "swiglu" else params["w1"]).shape[0]
    tok_idx, gates, slot_idx = build_queues(expert, gate, position, valid,
                                            e_num, capacity)
    live = tok_idx >= 0
    gi = torch.arange(g, device=x.device)[:, None, None]
    xq = torch.where(live[..., None], x.float()[gi, tok_idx.clamp_min(0)],
                     0.0)                                    # (G, E, C, d)
    table = device_table("silu" if kind == "swiglu" else "gelu", step_log2,
                         lut_range, x.device) if use_lut else None
    if kind == "swiglu":
        wg, wu, wd = (w.float() for w in _weights(params, kind))
        hg = torch.einsum("gecd,edf->gecf", xq, wg)
        hu = torch.einsum("gecd,edf->gecf", xq, wu)
        h = _activate(hg, kind, use_lut, table, step_log2) * hu
        y = torch.einsum("gecf,efd->gecd", h, wd)
    else:
        w1, b1, w2, b2 = (w.float() for w in _weights(params, kind))
        h = torch.einsum("gecd,edf->gecf", xq, w1) + b1[:, None, :]
        h = _activate(h, kind, use_lut, table, step_log2)
        y = torch.einsum("gecf,efd->gecd", h, w2) + b2[:, None, :]
    contrib = gates[..., None] * y
    # the slot scratch (G, T·k, d) with a scrap row at T·k for dead entries
    # (no host sync: the path stays capturable in a CUDA graph)
    flat = torch.where(live, tok_idx * k + slot_idx, t * k).long()
    slots = torch.zeros((g, t * k + 1, d), dtype=torch.float32,
                        device=x.device)
    slots[gi[..., 0], flat.reshape(g, -1)] = contrib.reshape(g, -1, d)
    slots = slots[:, :t * k].reshape(g, t, k, d)
    # each token's slots in ascending expert index, invalid ones last
    key = torch.where(valid, expert.long(), e_num)
    order = torch.sort(key, dim=-1, stable=True).indices
    acc = torch.zeros((g, t, d), dtype=torch.float32, device=x.device)
    for r in range(k):
        j = order[..., r]
        ok = torch.gather(valid, -1, j[..., None])[..., 0]
        row = torch.gather(slots, 2, j[..., None, None].expand(g, t, 1, d))
        acc = acc + torch.where(ok[..., None], row[:, :, 0], 0.0)
    return acc.to(x.dtype)


def _check(x, weights, kind, expert, group_sizes):
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"moe_fused kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    mats = weights[::2] if kind == "gelu" else weights
    if any(w.dtype != x.dtype for w in mats):
        raise TypeError("moe_fused kernel needs expert weights in x's dtype")
    if kind == "gelu" and any(b.dtype != torch.float32
                              for b in weights[1::2]):
        raise TypeError("moe_fused kernel takes float32 biases")
    g, t, d = x.shape
    e_num, d_w, f = mats[0].shape
    if d_w != d or mats[-1].shape != (e_num, f, d):
        raise ValueError(f"expert weights {[tuple(w.shape) for w in mats]} "
                         f"do not match x {tuple(x.shape)}")
    if not 0 < d <= MAX_D:
        raise ValueError(f"d {d} outside 1..{MAX_D}")
    if not 0 < expert.shape[-1] <= MAX_K:
        raise ValueError(f"top-k {expert.shape[-1]} outside 1..{MAX_K}")
    if group_sizes.shape != (g, e_num):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} != "
                         f"{(g, e_num)}")
    if g > 65535 or e_num > 65535:
        raise ValueError("groups or experts exceed the grid's limits")
    return g, t, d, e_num, f


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x, params, kind, capacity, table=None) -> gemm_plan.FusedPlan:
    """The plan the wrapper follows for a CUDA launch on these operands
    (x (G, T, d); ``table``: the LUT half-table, or None)."""
    return _plan(x, _weights(params, kind), kind, capacity, table)


def _plan(x, weights, kind, capacity, table):
    g, _, d = x.shape
    e_num, _, f = weights[0].shape
    return gemm_plan.plan_moe_fused(
        g, e_num, capacity, d, f, x.dtype, kind,
        _sm_count(x.device.index or 0),
        0 if table is None else table.shape[0],
        all(a.data_ptr() % 16 == 0 for a in (x, *weights)))


def _launch(x, params, expert, gate, position, valid, group_sizes, kind,
            capacity, use_lut, step_log2, lut_range):
    weights = [w.contiguous() for w in _weights(params, kind)]
    g, t, d, e_num, f = _check(x, weights, kind, expert, group_sizes)
    devices = {x.device, expert.device, group_sizes.device,
               *(w.device for w in weights)}
    if len(devices) != 1:
        raise ValueError("operands lie on different devices")
    k = expert.shape[-1]
    routing = [expert.to(torch.int32).contiguous(),
               gate.to(torch.float32).contiguous(),
               position.to(torch.int32).contiguous(),
               valid.to(torch.bool).contiguous()]
    sizes = group_sizes.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    table = device_table("silu" if kind == "swiglu" else "gelu", step_log2,
                         lut_range, x.device) if use_lut else None
    plan = _plan(x, weights, kind, capacity, table)
    # the queues (tok_idx, slot_idx, gates: build_queues' three arrays) are
    # built on the card by the launch itself
    queues = torch.empty((3, g, e_num, capacity), dtype=torch.int32,
                         device=x.device)
    scratch = torch.empty((g, t, k, d), dtype=torch.float32,
                          device=x.device)
    if kind == "swiglu":
        w1, wu, w2 = weights
        b1 = b2 = None
    else:
        w1, b1, w2, b2 = weights
        wu = None

    def ptr(a):
        return None if a is None else a.data_ptr()

    args = [x.data_ptr(), w1.data_ptr(), ptr(b1), ptr(wu), w2.data_ptr(),
            ptr(b2), sizes.data_ptr(), *(a.data_ptr() for a in routing),
            ptr(table), 0 if table is None else table.shape[0],
            float(2.0 ** (-step_log2)), queues.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), g, e_num, capacity, t, k, d,
            f, KINDS[kind], int(bool(use_lut))]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.variant == "tc":
        fn = build.function("moe_fused_tc_launch", _ARGS + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        err = fn(*args, plan.ny, plan.stages, stream)
    else:
        fn = build.function("moe_fused_launch", _ARGS + [
            ctypes.c_int, ctypes.c_void_p])
        err = fn(*args, build.DTYPE_CODES[x.dtype], stream)
    build.check(f"moe_fused ({plan.variant})", err)
    fused_moe_ffn.variants[plan.variant] += 1
    fused_moe_ffn.launches += 1
    return out


# the arguments the two C entry points share (csrc/moe_fused.cu)
_ARGS = [*([ctypes.c_void_p] * 12), ctypes.c_int, ctypes.c_float,
         *([ctypes.c_void_p] * 3), *([ctypes.c_int] * 9)]


def fused_moe_ffn(x, params, expert, gate, position, valid, group_sizes, *,
                  kind, capacity, use_lut=True, step_log2=-8, lut_range=8.0):
    """Dispatch + expert MLPs + combine, one pass over every group.

    x: (G, T, d) token activations; params: the expert weights (``w1, b1,
    w2, b2`` or ``wg, wu, wd``, leading E axis); expert / gate / position /
    valid: the routing decision (G, T, k); group_sizes: (G, E) queue
    lengths.  Returns the gate-combined (G, T, d) output in ``x.dtype``.
    """
    if kind not in KINDS:
        raise ValueError(f"expert kind {kind!r} (expected gelu | swiglu)")
    kw = dict(kind=kind, capacity=capacity, use_lut=use_lut,
              step_log2=step_log2, lut_range=lut_range)
    if x.device.type in build.PLAIN_DEVICES:
        return fused_moe_ffn_plain(x, params, expert, gate, position, valid,
                                   group_sizes, **kw)
    if x.device.type == "cuda":
        return _launch(x.contiguous(), params, expert, gate, position, valid,
                       group_sizes, kind, capacity, use_lut, step_log2,
                       lut_range)
    raise ValueError(f"fused_moe_ffn runs on cuda, cpu or meta, "
                     f"not {x.device}")


fused_moe_ffn.launches = 0
fused_moe_ffn.variants = {"tc": 0, "simt": 0}
