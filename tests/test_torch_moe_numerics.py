"""The order of work of ``moe_fused``'s tensor-core (``tc``) kernel on the
card, modelled in float32 PyTorch on the CPU and held against the Pallas
kernel in interpret mode on the same NumPy inputs at M³ViT's widths (d 192,
f 768, 16 experts, top-4, capacity 68; two routing groups), under
``kernels/compare.py``'s tolerance (bf16: one bf16 ulp of the output plus
``1e-5 + 1e-5·|ref|``) plus ``moe_lut_allowance`` where the LUT is on.

The model (``csrc/moe_fused.cu:moe_fused_tc_kernel``): each expert's live
queue rows of every group packed into 64-row tiles
(``gemm_plan.fused_tile_rows``); x rows gathered in bf16; per 64-wide chunk
of f, ``h = x·w1[:, chunk]`` from bf16 operands (products exact in
float32), ``b1`` added to the float32 sum, the activation (the LUT or exact
GELU / SiLU) in float32, h split into the bf16 pair ``hi = bf16(h)``,
``lo = bf16(h − hi)`` and ``y += hi·w2[chunk] + lo·w2[chunk]``; f whole
in every tile at any number of groups, the two warpgroups taking its
chunks in turn, each in ascending order, their partial sums meeting as
``y_odd + y_even``; each live row writes ``gate · (y + b2)`` to its
(token, slot) of the scratch; each token sums its valid slots from 0 in
ascending expert index and casts once to bf16.  The same model
with a single bf16 h leaves the tolerance at M³ViT's shape: that is why
the kernel multiplies the pair.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jk
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core import routing as R
from repro_torch.core.gelu import device_table, exact_gelu, exact_silu, \
    lut_correction
from repro_torch.kernels import gemm_plan as gp
from repro_torch.kernels import moe_fused as kmf
from repro_torch.kernels.compare import (kernel_tolerance, moe_lut_allowance,
                                         within_tolerance)

BF16 = torch.bfloat16
SMS = 132          # H100 SXM
# M³ViT's MoE layer (configs/m3vit.py) over two routing groups
G, T, D, F, E, K, C = 2, 128, 192, 768, 16, 4, 68


def _bf16(a):
    """bf16 values as a JAX array and a CPU tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, tensor_from_numpy(np.asarray(j.astype(jnp.float32))).to(BF16)


def _f32(a):
    j = jnp.asarray(a, jnp.float32)
    return j, tensor_from_numpy(np.asarray(j))


def _act(h, kind, use_lut):
    if use_lut:
        return lut_correction(h, device_table(
            "silu" if kind == "swiglu" else "gelu", -8, 8.0, "cpu"), -8)
    return exact_silu(h) if kind == "swiglu" else exact_gelu(h)


def tc_model(x, params, r, sizes, *, kind, use_lut, pair=True):
    """The ``tc`` kernel's arithmetic: x (G, T, d) bf16, one routing ``r``
    of (G, T, k) with queue lengths ``sizes`` (G, E) -> (G, T, d) bf16."""
    g_num, t, d = x.shape
    k = r.expert.shape[-1]
    tok_idx, gates, slot_idx = kmf.build_queues(
        r.expert, r.gate, r.position, r.valid, E, C)
    w = {n: v.float() for n, v in params.items()}
    first = w["wg"] if kind == "swiglu" else w["w1"]
    f = first.shape[-1]
    plan = gp.plan_moe_fused(g_num, E, C, d, f, x.dtype, kind, SMS)
    assert plan.variant == "tc", plan.reason
    f_chunks = -(-f // gp.FUSED_CHUNK)
    scratch = torch.zeros((g_num, t, k, d))
    for (e, _tile), rows in gp.fused_tile_rows(sizes.tolist(), C).items():
        live = [(g, int(tok_idx[g, e, c]), int(slot_idx[g, e, c]),
                 float(gates[g, e, c])) for g, c in filter(None, rows)]
        xq = torch.zeros((gp.FUSED_ROWS, d))
        for i, (g, tok, _, _) in enumerate(live):
            xq[i] = x[g, tok].float()
        parts = []
        for wg in range(gp.FUSED_WGS):
            y = torch.zeros((gp.FUSED_ROWS, d))
            for c in range(wg, f_chunks, gp.FUSED_WGS):
                cols = slice(c * gp.FUSED_CHUNK, (c + 1) * gp.FUSED_CHUNK)
                if kind == "swiglu":
                    h = _act(xq @ w["wg"][e][:, cols], kind, use_lut) \
                        * (xq @ w["wu"][e][:, cols])
                    w_out = w["wd"][e][cols]
                else:
                    h = _act(xq @ w["w1"][e][:, cols] + w["b1"][e][cols],
                             kind, use_lut)
                    w_out = w["w2"][e][cols]
                hi = h.to(BF16).float()
                if pair:
                    lo = (h - hi).to(BF16).float()
                    y = y + (hi @ w_out + lo @ w_out)
                else:
                    y = y + hi @ w_out
            parts.append(y)
        y = parts[1] + parts[0]
        if kind == "gelu":
            y = y + w["b2"][e]
        for i, (g, tok, slot, gate) in enumerate(live):
            scratch[g, tok, slot] = torch.tensor(gate) * y[i]
    # each token's valid slots in ascending expert index
    key = torch.where(r.valid, r.expert.long(), E)
    order = torch.sort(key, dim=-1, stable=True).indices
    acc = torch.zeros((g_num, t, d))
    for j in range(k):
        slot = order[..., j]
        ok = torch.gather(r.valid, -1, slot[..., None])
        row = torch.gather(scratch, 2, slot[..., None, None].expand(
            g_num, t, 1, d))[:, :, 0]
        acc = acc + torch.where(ok, row, 0.0)
    return acc.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _case(kind, use_lut, seed=0):
    """Inputs at M³ViT's widths and the Pallas kernel's output (interpret
    mode, one routing group at a time), cached across the tests."""
    rng = np.random.default_rng(seed)
    xj, xt = _bf16(rng.normal(size=(G, T, D)))
    if kind == "swiglu":
        params = {"wg": _bf16(rng.normal(size=(E, D, F)) / np.sqrt(D)),
                  "wu": _bf16(rng.normal(size=(E, D, F)) / np.sqrt(D)),
                  "wd": _bf16(rng.normal(size=(E, F, D)) / np.sqrt(F))}
    else:
        params = {"w1": _bf16(rng.normal(size=(E, D, F)) / np.sqrt(D)),
                  "b1": _f32(rng.normal(size=(E, F)) * 0.1),
                  "w2": _bf16(rng.normal(size=(E, F, D)) / np.sqrt(F)),
                  "b2": _f32(rng.normal(size=(E, D)) * 0.1)}
    logits = rng.normal(size=(G, T, E)).astype(np.float32)
    r = R.route(torch.from_numpy(logits), K, C)
    sizes = R.dispatch_counts(r, E)
    jp = {n: v[0] for n, v in params.items()}
    outs = []
    for i in range(G):
        fields = [jnp.asarray(a[i].numpy()) for a in
                  (r.expert, r.gate, r.position, r.valid, sizes)]
        outs.append(jk.fused_moe_ffn(xj[i], jp, *fields, kind=kind,
                                     capacity=C, use_lut=use_lut,
                                     interpret=True))
    want = tensor_from_numpy(np.asarray(jnp.stack(outs).astype(jnp.float32)))
    tp = {n: v[1] for n, v in params.items()}
    return xt, tp, r, sizes, want


def _outside(got, want, extra):
    tol = kernel_tolerance(got, want, BF16, extra=extra)
    return float(((got.float() - want.float()).abs() > tol).float().mean())


@pytest.mark.parametrize("kind,use_lut", [("gelu", True), ("gelu", False),
                                          ("swiglu", False)],
                         ids=["gelu_lut", "gelu_exact", "swiglu_exact"])
def test_tc_model_matches_pallas(kind, use_lut):
    x, params, r, sizes, want = _case(kind, use_lut)
    got = tc_model(x, params, r, sizes, kind=kind, use_lut=use_lut)
    extra = moe_lut_allowance(x, params, r.expert, r.gate, r.valid,
                              kind=kind) if use_lut else None
    assert within_tolerance(got, want, BF16, extra=extra), \
        f"{_outside(got, want, extra):.2%} of outputs outside the tolerance"


def test_tc_model_packs_rows_of_several_groups_into_one_tile():
    """The inputs above do exercise the packing (some tile holds rows of
    both routing groups), with f whole at two groups as at eight."""
    _, _, _, sizes, _ = _case("gelu", True)
    assert gp.plan_moe_fused(G, E, C, D, F, BF16, "gelu", SMS).grid[1] == 1
    tiles = gp.fused_tile_rows(sizes.tolist(), C)
    assert any(len({row[0] for row in rows if row is not None}) > 1
               for rows in tiles.values())


def test_single_bf16_h_leaves_the_tolerance():
    """At M³ViT's shape an h rounded once to bf16 before ``h·w2`` puts a
    share of the outputs outside the tolerance that the hi/lo pair keeps
    (the record behind ``csrc/moe_fused.cu``'s choice of the pair)."""
    x, params, r, sizes, want = _case("gelu", True)
    extra = moe_lut_allowance(x, params, r.expert, r.gate, r.valid,
                              kind="gelu")
    single = _outside(tc_model(x, params, r, sizes, kind="gelu",
                               use_lut=True, pair=False), want, extra)
    assert single > 0.02, single
    assert _outside(tc_model(x, params, r, sizes, kind="gelu", use_lut=True),
                    want, extra) == 0.0
