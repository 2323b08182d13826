#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card (H100): M³ViT
serving through the kernels and through the fused MoE kernel, and
Llama-3.2-1B prefill + decode serving.

    python3 chip_smoke.py

Phases, each printing its lines:

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every ``src/repro_torch/csrc/*.cu`` kernel
   with ``nvcc`` for ``sm_90a`` (into ``build/``), with ptxas' register and
   spill report per entry function, and a ``cuobjdump -sass`` count of
   ``HGMMA`` in each instance of the two tensor-core GEMM kernels, of the
   tensor-core (``tc``) attention kernel and of the ``tc`` fused MoE
   kernel, whose build log must show no C7518 (ptxas serializing a
   ``wgmma``).
2. Each of the six kernels against its plain PyTorch version on the card,
   on made-up inputs: at the main paths' shapes (M³ViT at B = 8; the
   Llama-3.2-1B projections at M = 8 and M = 1024 and its causal GQA
   prefill attention; decode at B = 8, Smax 512, lengths spread over
   [0, 512], window unset and set) in bf16 and in float32, and at ragged
   cases (odd sizes, empty queues, dropped slots, a zero cache length);
   the max error beside the stated tolerance
   (``repro_torch.kernels.compare``).  The GEMMs add ``unified_linear`` at
   M = 1, 16, 72 against the LM widths, K off the 64-wide k-tile, two
   split-K launches that must be bit-identical, and ``moe_gemm`` with NaN
   in every queue tail, a whole group and an expert empty; every GEMM
   launch must move exactly the variant counter its planner names
   (``repro_torch.kernels.gemm_plan``).  ``flash_attention`` adds the
   transposed views the models hand over, Sq = 1 over a live cache prefix
   (the ``attention_decode``/``cuda`` route), head_dim 48 (``tc``), 40
   (``simt``) and 128, fully masked rows, float32 on ``simt``, and every
   launch must move exactly the variant counter its planner names
   (``repro_torch.kernels.attn_plan``); ``decode_fused`` adds cache lengths
   on and around its 64-key split boundaries (63, 64, 65, Smax), windows
   that leave whole splits unread, and a second launch that must be
   bit-identical; ``moe_fused`` adds every queue at capacity, all tokens
   routed to one expert (tiles spanning every group), an empty expert,
   top-1 and top-8, two routing groups,
   d = f = 768, d = 128, NaN in x rows that no queue reads, exact GELU,
   SwiGLU at M³ViT's widths and at ragged ones on ``tc`` and ``simt``,
   float32 on ``simt``,
   and a second launch that must be bit-identical; every launch
   must move exactly the variant counter its planner names
   (``gemm_plan.plan_moe_fused``).
3. The main path: an ``M3ViTServer`` at the full 12-layer ``CONFIG`` in
   bf16 under the ``cuda`` policy, with seeded random weights, answers 16
   requests (8 semseg, 8 depth) in batches of 8.  Output shapes and
   finiteness are checked, and each task's outputs are held to cosine
   >= 0.999 against the same forward under the plain eager/blocked/lut
   policy on the card.  Every kernel's launch count over the 16 requests
   must be > 0 and the dispatch report must show the kernels hit on the
   card.  Then each task's batch is timed: the median host wall time of 5
   calls (``repro_torch.serve.profile.wall_per_batch``).  The same 16
   requests are then served under ``cuda`` with ``moe_ffn="cuda_fused"``:
   cosine >= 0.999 against the plain policy, ``moe_fused`` launched 6 times
   per forward, every launch on ``tc``, ``moe_gemm`` and ``gelu_lut`` not
   at all; timed the same way.  After each of the two runs, frame 0 of
   each task served at batch 1, 2 and 4 must equal its row at batch 8 bit
   for bit (the reduction order of every kernel on these paths depends on
   the layer's widths, not on the batch).  Then the same 16 requests are
   served with expert paging under ``cuda``: 8 of each MoE layer's 16
   experts resident (``resident_fraction=0.5``), synchronously, then
   through the copy-stream ``TransferEngine`` (``async_paging=True``),
   then under a budget of four experts' bytes.  Each output must be
   ``np.array_equal`` to the all-resident ``cuda`` run's, ``moe_gemm``
   (every launch on ``tc``) and ``gelu_lut`` must launch and the dispatch
   report show the kernels hit on the card; the cache counters (hits,
   misses, evictions, bytes paged per batch, hit rate), the waves per
   layer, the transfers' stall and hidden time and overlap ratio, and ms
   per batch are printed.  These paged runs' launches are checked here
   and stay out of phase 5 (they run the same kernels at the same
   per-queue shapes as the ``cuda`` run).
4. The LM path: a ``ServingEngine`` at the full Llama-3.2-1B ``CONFIG``
   (16 layers, bf16, seeded random weights, ``max_len`` 512) under ``cuda``
   with ``attention_decode="cuda_fused"`` generates 32 greedy tokens for
   8 prompts of 128 tokens.  ``unified_linear`` and ``flash_attention``
   must launch and ``decode_fused`` 16 times per decode step, all hits on
   the card; then the prefill and every decode step are replayed,
   teacher-forced on the generated tokens, under the kernel policy (whose
   argmax must give back the generated tokens) and under the plain
   ``eager`` policy on the card, with cosine >= 0.999 between the two
   logits at every step.  Prefill ms, ms per decode step and tokens/s.
5. The kernels at the main paths' own inputs.  Beside each counted run of
   phases 3 and 4 an uncounted twin (one more forward of each task; the
   teacher-forced replay of the prefill and the 32 decode steps) records
   the arguments of every kernel launch.  Each distinct recorded launch
   (by shape and data) is held against its plain version and timed alone
   (a CUDA graph of 10 calls on the same operands, which stay warm in L2;
   CUDA events, median of 20 replays after warm-up).  Then each recorded
   run's launches are replayed in their recorded order, as one CUDA graph,
   so every launch meets its own operands as in the path: the kernels,
   the plain versions, and one library call for each (``torch.matmul``,
   SDPA, ``torch.bmm``; yardsticks only) — ``moe_fused`` has no single
   library call, and beside it the staged ``cuda`` path (dispatch, 2 ×
   ``moe_gemm``, ``gelu_lut``, combine) is replayed on the same routing.
   The least time the card could take is the larger of the bytes moved
   (each input read once, each output written once) at 3.35 TB/s and the
   operations at the peak rate for the type (989 TFLOP/s bf16, 67 TFLOP/s
   float32), counting the work this run's data needs (live queue rows,
   visible keys), summed over the launches.

Each main-path run sets every launch count to 0 just before it and reads
them just after; a kernel's ``launches`` in the JSON line is the sum over
those runs.  The variant counters (the GEMMs', ``flash_attention``'s,
``moe_fused``'s) are read with them: no main path may take the SIMT
route, and the variants the recorded launches were planned on must
equal the counted ones (``variants`` in the JSON line and per unit).
The recorded launches must match the counted ones kernel by kernel, and
a kernel's times and bound in the JSON line cover exactly those launches
(in-order replays; ``alone_ms`` sums the launches timed alone), with a
breakdown (``units``) per recorded twin.

The plain versions run in full float32: TF32 is switched off for matmuls
and for cuDNN before anything runs.  Any failed check raises; the last two
lines are the kernels' JSON record and the result line.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12}     # float32 outside the tensor cores
BATCH = 8
TOKENS = 128 * BATCH

REPLACES = {
    "unified_linear": "src/repro/kernels/unified_linear.py:49",
    "flash_attention": "src/repro/kernels/flash_attention.py:40",
    "gelu_lut": "src/repro/kernels/gelu_lut.py:28",
    "moe_gemm": "src/repro/kernels/moe_gemm.py:33",
    "moe_fused": "src/repro/kernels/moe_fused.py:60",
    "decode_fused": "src/repro/kernels/decode_fused.py:43",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
CUDA_PATH_KERNELS = ("unified_linear", "flash_attention", "gelu_lut",
                     "moe_gemm")
LM_BATCH, LM_PROMPT, LM_NEW, LM_MAX_LEN = 8, 128, 32, 512


def time_ms(fn, reps: int = 20, calls: int = 10) -> float:
    """Device time of one call: ``calls`` calls are captured in a CUDA graph
    (so no host gap sits between them), the graph is replayed ``reps``
    times between CUDA events after a warm-up, and the median replay time
    over ``calls`` is returned."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, float]:
    """(ms to move the bytes at the HBM rate, ms to do the operations at
    the peak rate for ``dtype``); the bound is the larger."""
    return (nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3)


def randn(shape, dtype, scale=1.0, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _dt(t) -> str:
    return str(t.dtype)[6:]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check(name, label, got, want, dtype, **kw) -> float:
    """Hold a kernel's output against its plain version's under the stated
    tolerance; raises on disagreement, returns the max abs error."""
    from repro_torch.kernels.compare import max_abs_err, within_tolerance

    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ok = within_tolerance(got, want, dtype, **kw)
    rule = ("float32 1e-5+1e-5|ref|" if dtype == torch.float32
            else "1 bf16 ulp + float32 tol")
    if kw.get("lut_pre") is not None:
        rule += " (+1 table step at LUT index ties)"
    if kw.get("extra") is not None:
        rule += " (+ LUT index ties carried through w2)"
    print(f"  {name} {label}: max_abs_err {err:.3e} tolerance {rule}: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label}: kernel disagrees with its "
                             f"plain version (max err {err})")
    return err


def check_exact(name, label, got, want) -> float:
    torch.cuda.synchronize()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not bool(same.all()):
        raise AssertionError(f"{name} {label}: not bit-exact")
    print(f"  {name} {label}: max_abs_err 0.000e+00 tolerance bit-exact: ok")
    return 0.0


# ------------------------------------------------------------ phase 2


def planned(name, wrapper, plan, call):
    """Run ``call`` (one launch of a GEMM wrapper) and check that exactly
    the variant its planner chose counted it; returns the output."""
    before = dict(wrapper.variants)
    out = call()
    moved = {v: wrapper.variants[v] - before[v] for v in before}
    want = {v: int(v == plan.variant) for v in before}
    if moved != want:
        raise AssertionError(f"{name}: planned {plan.variant} "
                             f"({plan.reason}), counters moved {moved}")
    return out


def _plan_label(plan) -> str:
    if plan.variant == "simt":
        return "simt"
    return (f"{plan.variant} {64 * plan.nwg}x{plan.bt} tiles, "
            f"{plan.splits} split(s), {plan.stages} stages, "
            f"{plan.blocks} blocks")


def check_unified_linear() -> None:
    from repro_torch.kernels import unified_linear as kul

    def one(label, x, w, b=None, act=None, lut=False):
        plan = kul.plan_for(x, w)
        got = planned("unified_linear", kul.unified_linear, plan,
                      lambda: kul.unified_linear(x, w, b, activation=act,
                                                 use_lut=lut))
        want = kul.unified_linear_plain(x, w, b, activation=act, use_lut=lut)
        # the LUT rule reads the float32 pre-activation (compare.py)
        pre = kul.unified_linear_plain(x.float(), w.float(), b) if lut \
            else None
        m, k = x.shape
        check("unified_linear", f"{label} M={m} K={k} N={w.shape[1]} "
              f"{_dt(x)} [{_plan_label(plan)}]", got, want, x.dtype,
              lut_pre=pre, kind=act or "gelu")
        return got

    # (label, M, K, N, bias, activation, LUT): M3ViT at B = 8, then the
    # Llama-3.2-1B projections at decode (M = 8) and prefill (M = 1024)
    shapes = [("patch_embed", TOKENS, 768, 192, True, None, False),
              ("qkvo", TOKENS, 192, 192, False, None, False),
              ("mlp_up_gelu_lut", TOKENS, 192, 768, True, "gelu", True),
              ("mlp_down", TOKENS, 768, 192, True, None, False),
              ("semseg_head", TOKENS, 192, 4864, True, None, False),
              ("depth_head", TOKENS, 192, 256, True, None, False)]
    lm = [("lm_q_o", 2048, 2048, False, None, False),
          ("lm_k_v", 2048, 512, False, None, False),
          ("lm_gate_silu_lut", 2048, 8192, False, "silu", True),
          ("lm_up", 2048, 8192, False, None, False),
          ("lm_down", 8192, 2048, False, None, False)]
    for m in (LM_BATCH, LM_BATCH * LM_PROMPT):
        shapes += [(label, m, k, n, b, act, lut)
                   for label, k, n, b, act, lut in lm]
    for dtype in (torch.bfloat16, torch.float32):
        for i, (label, m, k, n, has_b, act, lut) in enumerate(shapes):
            x = randn((m, k), dtype, seed=100 + i)
            w = randn((k, n), dtype, 1.0 / math.sqrt(k), seed=200 + i)
            b = randn((n,), torch.float32, 0.1, seed=300 + i) if has_b \
                else None
            one(label, x, w, b, act, lut)
    # the tensor-core path at the other small M against the LM widths
    for m in (1, 16, 72):
        for i, (label, k, n, has_b, act, lut) in enumerate(lm):
            x = randn((m, k), torch.bfloat16, seed=110 + i)
            w = randn((k, n), torch.bfloat16, 1.0 / math.sqrt(k),
                      seed=210 + i)
            one(label, x, w, None, act, lut)
    # K not a multiple of the 64-wide k-tile (the map zero-fills past K)
    for m, k, n in ((LM_BATCH, 2056, 512), (TOKENS, 200, 192),
                    (72, 1000, 264)):
        x = randn((m, k), torch.bfloat16, seed=45)
        w = randn((k, n), torch.bfloat16, 1.0 / math.sqrt(k), seed=46)
        b = randn((n,), torch.float32, 0.1, seed=47)
        one("K off the k-tile", x, w, b, "gelu")
    # split-K is deterministic: two launches on the same inputs, bit-equal
    x = randn((LM_BATCH, 8192), torch.bfloat16, seed=48)
    w = randn((8192, 2048), torch.bfloat16, 8192 ** -0.5, seed=49)
    first = one("split-K run 1", x, w)
    check_exact("unified_linear", f"split-K run 2 against run 1 "
                f"[{_plan_label(kul.plan_for(x, w))}]",
                kul.unified_linear(x, w), first)
    # why the kernel promotes its wgmma sums into a float32 register tile
    # every few k-tiles: one library bf16 product, which accumulates on the
    # tensor cores throughout, at the longest K of the main paths (a
    # reading, not a check)
    from repro_torch.kernels.compare import kernel_tolerance

    x = randn((TOKENS, 8192), torch.bfloat16, seed=50)
    w = randn((8192, 2048), torch.bfloat16, 8192 ** -0.5, seed=51)
    want = kul.unified_linear_plain(x, w)
    for label, got in (("torch.matmul", torch.matmul(x, w)),
                       ("unified_linear", kul.unified_linear(x, w))):
        out = int(((got.float() - want.float()).abs()
                   > kernel_tolerance(got, want, torch.bfloat16)).sum())
        print(f"  {label} bf16 M={TOKENS} K=8192 N=2048: {out} of "
              f"{want.numel()} outputs outside the bf16 tolerance")
    # ragged: odd M, K, N; SiLU through the LUT epilogue; float32
    x = randn((1000, 190), torch.float32, seed=40)
    w = randn((190, 770), torch.float32, 0.07, seed=41)
    b = randn((770,), torch.float32, 0.1, seed=42)
    one("ragged silu-lut", x, w, b, "silu", True)
    # bf16 rows of 66 bytes: TMA cannot address them, the SIMT route does
    x16 = randn((77, 33), torch.bfloat16, seed=43)
    w16 = randn((33, 129), torch.bfloat16, 0.2, seed=44)
    if kul.plan_for(x16, w16).variant != "simt":
        raise AssertionError("K=33 bf16 must be planned on the SIMT route")
    one("ragged erf-gelu", x16, w16, b[:129], "gelu")


def _attn_label(plan) -> str:
    if plan.variant == "simt":
        return f"simt, {plan.blocks} blocks of {plan.rows} rows"
    return (f"tc, {plan.blocks} blocks of {plan.rows} rows, {plan.atoms} "
            f"head-dim atom(s)")


def _split_heads_view(b, s, h, d, dtype, seed):
    """(B, H, S, D) as ``models/layers.py:_split_heads`` hands it over: a
    transposed view of (B, S, H, D)."""
    return randn((b, s, h, d), dtype, seed=seed).transpose(1, 2)


def check_flash_attention() -> None:
    from repro_torch.kernels import flash_attention as kfa

    def one(label, q, k, v, **kw):
        plan = kfa.plan_for(q)
        got = planned("flash_attention", kfa.flash_attention, plan,
                      lambda: kfa.flash_attention(q, k, v, **kw))
        check("flash_attention", f"{label} q {tuple(q.shape)} k/v "
              f"{tuple(k.shape)} {kw} {_dt(q)} [{_attn_label(plan)}]", got,
              kfa.flash_attention_plain(q, k, v, **kw), q.dtype)
        return got

    # M3ViT self-attention, then the Llama-3.2-1B prefill — causal GQA
    # 32/8 against the whole cache; q (and M3ViT's k, v) as the transposed
    # views the model hands over, which the tc kernel reads as they lie
    for dtype in (torch.bfloat16, torch.float32):
        one("M3ViT", *(_split_heads_view(BATCH, 128, 3, 64, dtype, seed)
                       for seed in (1, 2, 3)), causal=False)
        one("Llama-3.2-1B prefill",
            _split_heads_view(LM_BATCH, LM_PROMPT, 32, 64, dtype, 1),
            randn((LM_BATCH, 8, LM_MAX_LEN, 64), dtype, seed=2),
            randn((LM_BATCH, 8, LM_MAX_LEN, 64), dtype, seed=3),
            causal=True, q_offset=0)
    # the same inputs contiguous
    one("M3ViT contiguous", *(randn((BATCH, 3, 128, 64), torch.bfloat16,
                                    seed=seed) for seed in (1, 2, 3)),
        causal=False)
    # Sq = 1 over a live prefix of the cache: the attention_decode/cuda
    # route (ops/impls.py:_decode_cuda)
    kc = randn((LM_BATCH, 8, LM_MAX_LEN, 64), torch.bfloat16, seed=7)
    vc = randn((LM_BATCH, 8, LM_MAX_LEN, 64), torch.bfloat16, seed=8)
    for length in (1, 150, LM_MAX_LEN):
        one(f"Sq=1 over the live prefix {length}",
            randn((LM_BATCH, 32, 1, 64), torch.bfloat16, seed=9),
            kc[:, :, :length], vc[:, :, :length], causal=True,
            q_offset=length - 1)
    # ragged: GQA 6/2, Sq 77 vs Skv 100, causal + window + q_offset, at
    # head_dim 48 (tc: one atom, 16 zero columns) and 40 (simt)
    for d in (48, 40):
        one(f"ragged GQA 6/2 D={d}",
            randn((2, 6, 77, d), torch.bfloat16, seed=4),
            randn((2, 2, 100, d), torch.bfloat16, seed=5),
            randn((2, 2, 100, d), torch.bfloat16, seed=6),
            causal=True, window=24, q_offset=23)
    # head_dim 128 (two atoms), K tail off the 64-key tile
    one("D=128", randn((2, 4, 130, 128), torch.bfloat16, seed=10),
        randn((2, 2, 200, 128), torch.bfloat16, seed=11),
        randn((2, 2, 200, 128), torch.bfloat16, seed=12), causal=True,
        q_offset=70)
    # fully masked rows: queries at positions -4.. see no key (causal),
    # the window leaves each later one two
    for dtype in (torch.bfloat16, torch.float32):
        got = one("fully masked rows", randn((1, 2, 70, 64), dtype, seed=13),
                  randn((1, 2, 20, 64), dtype, seed=14),
                  randn((1, 2, 20, 64), dtype, seed=15), causal=True,
                  window=2, q_offset=-4)
        if bool((got[:, :, :4] != 0).any()):
            raise AssertionError("flash_attention: a fully masked row is "
                                 "not exactly zero")


def check_gelu_lut() -> None:
    from repro_torch.kernels import gelu_lut as kgl

    shape = (BATCH, 16, 68, 768)     # MoE hidden after + b1
    for dtype in (torch.float32, torch.bfloat16):
        x = randn(shape, dtype, 3.0, seed=7)
        check_exact("gelu_lut", f"G={BATCH} E=16 C=68 F=768 {_dt(x)}",
                    kgl.lut_activation(x), kgl.lut_activation_plain(x))
    # ragged: odd length with ±inf, NaN, values past the table, exact
    # index half-steps (half-to-even rounding)
    x = randn((1_000_003,), torch.float32, 4.0, seed=8)
    special = torch.tensor(
        [math.inf, -math.inf, math.nan, 0.0, -0.0, 8.0, -8.0, 9.5, 1e30,
         -1e30] + [(i + 0.5) / 256 for i in range(64)], device="cuda")
    x[:special.numel()] = special
    check_exact("gelu_lut", "ragged n=1000003 silu float32 with inf/nan/"
                "past-table/half-steps", kgl.lut_activation(x, "silu"),
                kgl.lut_activation_plain(x, "silu"))


def _zero_tails(name, got, sizes):
    keep = torch.arange(got.shape[-2], device=got.device)[None, None, :,
                                                          None] \
        < sizes[:, :, None, None]
    if bool((got.masked_select(~keep) != 0).any()):
        raise AssertionError(f"{name}: rows past a queue not zero")


def check_moe_gemm() -> None:
    from repro_torch.core import routing as R
    from repro_torch.kernels import moe_gemm as kmg

    def one(label, buf, w, sizes):
        plan = kmg.plan_for(buf, w)
        got = planned("moe_gemm", kmg.moe_gemm, plan,
                      lambda: kmg.moe_gemm(buf, w, sizes))
        g, e, c, d = buf.shape
        check("moe_gemm", f"{label} G={g} E={e} C={c} D={d} "
              f"F={w.shape[2]} {_dt(buf)} ({int(sizes.sum())} rows live) "
              f"[{_plan_label(plan)}]", got,
              kmg.moe_gemm_plain(buf, w, sizes), buf.dtype)
        _zero_tails(f"moe_gemm {label}", got, sizes)

    # queue lengths from top-4 routing of random logits, 8 groups x 128
    logits = randn((BATCH, 128, 16), torch.float32, seed=9)
    sizes = R.dispatch_counts(R.route(logits, 4, 68), 16)
    for dtype in (torch.bfloat16, torch.float32):
        for label, d, f in (("w1", 192, 768), ("w2", 768, 192)):
            buf = randn((BATCH, 16, 68, d), dtype, seed=11)
            w = randn((16, d, f), dtype, 1.0 / math.sqrt(d), seed=12)
            one(label, buf, w, sizes)
    # NaN in every queue tail, a whole group empty, one expert empty in
    # every group, one queue full
    tails = sizes.clone()
    tails[0] = 0
    tails[:, 5] = 0
    tails[1, 3] = 68
    for label, d, f in (("w1", 192, 768), ("w2", 768, 192)):
        buf = randn((BATCH, 16, 68, d), torch.bfloat16, seed=15)
        rows = torch.arange(68, device="cuda")[None, None, :, None]
        buf = torch.where(rows < tails[:, :, None, None], buf,
                          torch.full((), math.nan, dtype=torch.bfloat16,
                                     device="cuda"))
        w = randn((16, d, f), torch.bfloat16, 1.0 / math.sqrt(d), seed=16)
        one(f"{label} NaN tails, group 0 and expert 5 empty", buf, w, tails)
    # ragged: 3 groups x 5 experts, C=13, D=37, F=29, empty and partial
    # queues, garbage in the queue tails
    rs = torch.tensor([[0, 13, 7, 0, 1], [5, 0, 0, 13, 2], [0, 0, 0, 0, 0]],
                      dtype=torch.int32, device="cuda")
    one("ragged", randn((3, 5, 13, 37), torch.float32, seed=13),
        randn((5, 37, 29), torch.float32, 0.2, seed=14), rs)
    # ragged on the tensor cores: C=13 (a 16-row tile), D=40 (one partial
    # k-tile), F=72 (a partial 64-column tile)
    one("ragged", randn((3, 5, 13, 40), torch.bfloat16, seed=17),
        randn((5, 40, 72), torch.bfloat16, 0.2, seed=18), rs)


def _fused_label(plan) -> str:
    if plan.variant == "simt":
        return "simt"
    return (f"tc {64 * plan.ny}-column slices, F whole, "
            f"{plan.stages} stages, {plan.blocks} blocks")


def _fused_params(kind, e, d, f, dtype, seed):
    if kind == "swiglu":
        return {"wg": randn((e, d, f), dtype, d ** -0.5, seed=seed),
                "wu": randn((e, d, f), dtype, d ** -0.5, seed=seed + 1),
                "wd": randn((e, f, d), dtype, f ** -0.5, seed=seed + 2)}
    return {"w1": randn((e, d, f), dtype, d ** -0.5, seed=seed),
            "b1": randn((e, f), torch.float32, 0.1, seed=seed + 1),
            "w2": randn((e, f, d), dtype, f ** -0.5, seed=seed + 2),
            "b2": randn((e, d), torch.float32, 0.1, seed=seed + 3)}


def check_moe_fused() -> None:
    from repro_torch.core import routing as R
    from repro_torch.core.gelu import device_table
    from repro_torch.kernels import moe_fused as kmf
    from repro_torch.kernels.compare import moe_lut_allowance

    def run(label, x, p, r, c, kind="gelu", use_lut=True):
        """One launch, which must move exactly its planned variant counter,
        held against the plain version; returns the output and a second
        launch on the same inputs."""
        e = p["wg" if kind == "swiglu" else "w1"].shape[0]
        sizes = R.dispatch_counts(r, e)
        args = (x, p, r.expert, r.gate, r.position, r.valid, sizes)
        kw = dict(kind=kind, capacity=c, use_lut=use_lut)
        table = device_table("silu" if kind == "swiglu" else "gelu", -8, 8.0,
                             x.device) if use_lut else None
        plan = kmf.plan_for(x, p, kind, c, table)
        got = planned("moe_fused", kmf.fused_moe_ffn, plan,
                      lambda: kmf.fused_moe_ffn(*args, **kw))
        g, t, d = x.shape
        check("moe_fused", f"{label}: G={g} T={t} E={e} "
              f"top-{r.expert.shape[-1]} C={c} d={d} {kind}"
              f"{'-lut' if use_lut else ' exact'} {_dt(x)}, "
              f"{int(sizes.sum())} of {r.valid.numel()} slots live "
              f"[{_fused_label(plan)}]", got,
              kmf.fused_moe_ffn_plain(*args, **kw), x.dtype,
              extra=moe_lut_allowance(x, p, r.expert, r.gate, r.valid,
                                      kind=kind) if use_lut else None)
        return got, lambda: planned("moe_fused", kmf.fused_moe_ffn, plan,
                                    lambda: kmf.fused_moe_ffn(*args, **kw))

    def routed(g, t, e, k, c, seed, hot=None, cold=None):
        logits = randn((g, t, e), torch.float32, seed=seed)
        if hot is not None:
            logits[..., hot] = 30.0
        if cold is not None:
            logits[..., cold] = -30.0
        return R.route(logits, k, c)

    g, t, e, k, d, f, c = BATCH, 128, 16, 4, 192, 768, 68
    r = routed(g, t, e, k, c, seed=50)
    for dtype in (torch.float32, torch.bfloat16):   # simt, then tc
        x = randn((g, t, d), dtype, seed=51)
        p = _fused_params("gelu", e, d, f, dtype, seed=52)
        first, again = run("M3ViT layer", x, p, r, c)
    # x, p: the bf16 layer; a second launch on the same inputs is
    # bit-identical to the first
    check_exact("moe_fused", "second launch on the same inputs", again(),
                first)
    run("exact GELU", x, p, r, c, use_lut=False)
    run("SwiGLU, SiLU through the LUT", x,
        _fused_params("swiglu", e, d, f, torch.bfloat16, seed=76), r, c,
        kind="swiglu")
    # every queue at capacity: 272 tokens a group, token t's slots to
    # experts 4t..4t+3 (mod 16), 68 slots each
    tf = 272
    dev = r.expert.device
    expert = ((4 * torch.arange(tf, device=dev)[:, None]
               + torch.arange(k, device=dev)) % e).int().expand(
                   g, tf, k).contiguous()
    position, valid = R.build_dispatch(expert, e, c)
    gate = torch.softmax(randn((g, tf, k), torch.float32, seed=60), -1)
    full = R.Routing(expert=expert, gate=gate,
                     position=position, valid=valid, probs=None)
    if not bool((R.dispatch_counts(full, e) == c).all()):
        raise AssertionError("moe_fused: expected every queue at capacity")
    run("every queue at capacity", randn((g, tf, d), torch.bfloat16,
                                         seed=61), p, full, c)
    # every token's one slot to expert 3: 60 rows a group, so each 64-row
    # tile spans two groups and the expert's tiles span all eight
    run("all tokens to one expert", randn((g, 60, d), torch.bfloat16,
                                          seed=62), p,
        routed(g, 60, e, 1, c, seed=63, hot=3), c)
    one_empty = routed(g, t, e, k, c, seed=64, cold=7)
    if bool((R.dispatch_counts(one_empty, e)[:, 7] != 0).any()):
        raise AssertionError("moe_fused: expected expert 7 empty")
    run("one empty expert", x, p, one_empty, c)
    run("top-1", x, p, routed(g, t, e, 1, c, seed=65), c)
    # two routing groups: a grid of 48 blocks for 132 SMs, f whole
    run("batch 2", x[:2].contiguous(), p, routed(2, t, e, k, c, seed=73), c)
    run("top-8 (capacity drops)", x, p, routed(g, t, e, 8, c, seed=66), c)
    # top-1 at capacity 4 drops most tokens; their x rows hold NaN, which no
    # queue reads and which must not reach any output
    sparse = routed(g, t, e, 1, 4, seed=67)
    dropped = ~sparse.valid.any(dim=-1)
    xn = x.clone()
    xn[dropped] = float("nan")
    got, _ = run("NaN in the x rows no queue reads", xn, p, sparse, 4)
    if not bool(dropped.any()) or not bool(torch.isfinite(got).all()) \
            or bool((got[dropped] != 0).any()):
        raise AssertionError("moe_fused: NaN rows of dropped tokens leaked "
                             "or dropped tokens were not exact zeros")
    # d = f = 768: four 192-column d-slices, a one-stage ring; d = 128:
    # one slice of two 64-column atoms
    run("d = f = 768", randn((g, t, 768), torch.bfloat16, seed=68),
        _fused_params("gelu", e, 768, 768, torch.bfloat16, seed=69), r, c)
    run("d = 128, f = 256", randn((g, t, 128), torch.bfloat16, seed=74),
        _fused_params("gelu", e, 128, 256, torch.bfloat16, seed=75), r, c)
    # ragged: 3 groups of 37 tokens, 5 SwiGLU experts with one never
    # chosen, top-2 at a capacity that drops slots, exact SiLU — on the
    # tensor cores at d = 24, f = 40 (partial atoms and chunks), then at
    # d = 36 (72-byte rows: simt) and in float32 (simt)
    ragged = routed(3, 37, 5, 2, 12, seed=70, cold=3)
    for dtype, dr in ((torch.bfloat16, 24), (torch.bfloat16, 36),
                      (torch.float32, 24)):
        got, _ = run("ragged (one empty expert)",
                     randn((3, 37, dr), dtype, seed=71),
                     _fused_params("swiglu", 5, dr, 40, dtype, seed=72),
                     ragged, 12, kind="swiglu", use_lut=False)
        dropped = ~ragged.valid.any(dim=-1)
        if not bool(dropped.any()) or bool((got[dropped] != 0).any()) \
                or bool((R.dispatch_counts(ragged, 5)[:, 3] != 0).any()):
            raise AssertionError("moe_fused ragged: expected an empty "
                                 "expert and dropped tokens with exact "
                                 "zeros")


def check_decode_fused() -> None:
    from repro_torch.kernels import attn_plan
    from repro_torch.kernels import decode_fused as kdf

    b, hq, hkv, smax, d = LM_BATCH, 32, 8, LM_MAX_LEN, 64
    # a zero length, Smax, and lengths on and around the 64-key split
    # boundaries
    cl = torch.tensor([0, 512, 1, 63, 64, 65, 300, 129], dtype=torch.int32,
                      device="cuda")
    plan = attn_plan.plan_decode(b, hq, hkv, smax)
    splits = f"{plan.splits} splits of {plan.split} keys, {plan.blocks} blocks"
    for dtype in (torch.bfloat16, torch.float32):
        # window 100 leaves the splits wholly behind the frontier unread
        for window in (None, 100, 5):
            q = randn((b, hq, 1, d), dtype, seed=61)
            k = randn((b, hkv, smax, d), dtype, seed=62)
            v = randn((b, hkv, smax, d), dtype, seed=63)
            got = kdf.fused_decode_attention(q, k, v, cl, window=window)
            label = (f"B={b} Hq={hq} Hkv={hkv} Smax={smax} D={d} cache_len "
                     f"{cl.tolist()} window={window} {_dt(q)} [{splits}]")
            check("decode_fused", label, got,
                  kdf.fused_decode_attention_plain(q, k, v, cl,
                                                   window=window), dtype)
            if bool((got[0] != 0).any()):
                raise AssertionError("decode_fused: cache_len 0 not zero")
            # the splits merge in a fixed order: a second launch is
            # bit-identical
            check_exact("decode_fused", f"{label} run 2 against run 1",
                        kdf.fused_decode_attention(q, k, v, cl,
                                                   window=window), got)
    # ragged: GQA 6/2 (group 3), head_dim 128, odd Smax, a zero length
    q = randn((3, 6, 1, 128), torch.float32, seed=64)
    k = randn((3, 2, 70, 128), torch.float32, seed=65)
    v = randn((3, 2, 70, 128), torch.float32, seed=66)
    cl3 = torch.tensor([70, 0, 9], dtype=torch.int32, device="cuda")
    check("decode_fused", "ragged B=3 Hq=6 Hkv=2 Smax=70 D=128 cache_len "
          "[70, 0, 9] window=5 float32",
          kdf.fused_decode_attention(q, k, v, cl3, window=5),
          kdf.fused_decode_attention_plain(q, k, v, cl3, window=5),
          torch.float32)
    # ragged: a group of 12 in two chunks of heads, at head_dim 40 (rows of
    # 80 bytes: 16-byte copies) and 36 (72 bytes: element copies)
    cl2 = torch.tensor([130, 65], dtype=torch.int32, device="cuda")
    for d in (40, 36):
        q = randn((2, 24, 1, d), torch.bfloat16, seed=67)
        k = randn((2, 2, 130, d), torch.bfloat16, seed=68)
        v = randn((2, 2, 130, d), torch.bfloat16, seed=69)
        check("decode_fused", f"ragged B=2 Hq=24 Hkv=2 Smax=130 D={d} "
              f"cache_len [130, 65] bf16",
              kdf.fused_decode_attention(q, k, v, cl2),
              kdf.fused_decode_attention_plain(q, k, v, cl2), torch.bfloat16)


# ------------------------------------------------------- launch records


class Unit(NamedTuple):
    """The kernel launches of one uncounted twin of a counted run."""

    label: str      # what one run is
    runs: int       # forwards or decode steps recorded
    calls: dict     # kernel name -> [launch arguments, in launch order]


@contextlib.contextmanager
def recorded_launches(calls: dict):
    """Record the arguments of every kernel launch made inside the block
    into ``calls`` (kernel name -> list), at each kernel module's
    ``_launch`` — the one place its wrapper launches and counts.  The
    launches run and count as they would."""
    from repro_torch import kernels

    saved = []
    for name, wrapper in kernels.KERNELS.items():
        mod = sys.modules[wrapper.__module__]

        def record(*args, _launch=mod._launch, _name=name):
            calls.setdefault(_name, []).append(args)
            return _launch(*args)

        saved.append((mod, mod._launch))
        mod._launch = record
    try:
        yield calls
    finally:
        for mod, launch in saved:
            mod._launch = launch


#: kernel -> variant -> launches, summed over the counted main-path runs
#: (the variant counters of the GEMM, flash_attention and moe_fused
#: wrappers)
COUNTED_VARIANTS: dict = {}


def read_variants(label) -> dict:
    """The variant counters of the GEMM, flash_attention and moe_fused
    wrappers after a counted run: printed, added to COUNTED_VARIANTS, and
    none may be the SIMT route (every main path runs bf16 at 16-byte
    aligned shapes and a head_dim of 64)."""
    from repro_torch.kernels import variant_counts

    counts = variant_counts()
    print(f"  kernel variants over {label}: {json.dumps(counts)}")
    for name, by in counts.items():
        if by.get("simt"):
            raise AssertionError(f"{name}: {by['simt']} SIMT launches on a "
                                 f"main path")
        total = COUNTED_VARIANTS.setdefault(name, {})
        for v, k in by.items():
            total[v] = total.get(v, 0) + k
    return counts


# ------------------------------------------------------------ phase 3


def _m3vit_twins(server, batches, policy_label, units):
    """One more (uncounted) forward of each task, its launches recorded."""
    for task, imgs in batches:
        with recorded_launches({}) as calls:
            server.infer(imgs, task)
        units.append(Unit(f"M3ViT {task} forward, B={BATCH}, "
                          f"{policy_label}", 1, calls))


def main_path(units):
    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import cosine
    from repro_torch.models.vit import init_params
    from repro_torch.serve.vision import M3ViTServer

    cfg = replace(MV.CONFIG, policy=ops.policy_named("cuda"))
    plain_cfg = replace(MV.CONFIG, policy=ops.policy_named("blocked"))
    params = init_params(0, cfg)
    server = M3ViTServer(cfg, params)
    plain = M3ViTServer(plain_cfg, params)
    rng = np.random.default_rng(0)
    requests = [(MV.TASKS[i // 8],
                 rng.normal(size=(MV.IMAGE_H, MV.IMAGE_W, 3))
                 .astype(np.float32)) for i in range(16)]
    batches = [(task, np.stack([img for t, img in requests if t == task]))
               for task in MV.TASKS]
    print(f"  M3ViT {cfg.num_layers} layers d={cfg.d_model} "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} "
          f"{cfg.dtype}: 16 requests (8 semseg, 8 depth) in batches of 8")
    for task, imgs in batches * 3:          # warm-up, not counted
        server.infer(imgs, task)
    _m3vit_twins(server, batches, "policy cuda", units)
    torch.cuda.synchronize()

    reset_launch_counts()
    ops.reset_dispatch_report()
    outs = {task: server.infer(imgs, task)      # returns on the host
            for task, imgs in batches}
    counts = launch_counts()
    report = ops.dispatch_report()
    read_variants("the 16 requests")

    expected = {"semseg": (BATCH, MV.IMAGE_H, MV.IMAGE_W,
                           MV.NUM_SEG_CLASSES),
                "depth": (BATCH, MV.IMAGE_H, MV.IMAGE_W)}
    for task, imgs in batches:
        y = outs[task]
        if y.shape != expected[task] or not np.isfinite(y).all():
            raise AssertionError(f"{task}: output {y.shape} not finite of "
                                 f"shape {expected[task]}")
        ref = plain.infer(imgs, task)
        cos = cosine(torch.from_numpy(y), torch.from_numpy(ref))
        print(f"  {task}: output {tuple(y.shape)} finite; cosine vs plain "
              f"eager/blocked/lut policy on the card {cos:.6f} "
              f"(>= 0.999: {'ok' if cos >= 0.999 else 'FAIL'})")
        if cos < 0.999:
            raise AssertionError(f"{task}: cosine {cos} < 0.999")
    print(f"  launches over the 16 requests: {json.dumps(counts)}")
    if not all(counts[n] > 0 for n in CUDA_PATH_KERNELS):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{counts}")
    for op in ("linear", "attention", "moe_grouped_gemm", "activation"):
        entry = report.get(op, {})
        if entry.get("fallbacks") or entry.get("modes", {}).get("cuda") \
                != {"cuda": entry.get("hits", {}).get("cuda", -1)}:
            raise AssertionError(f"dispatch report for {op}: {entry}")
    print(f"  dispatch report: {json.dumps(report)}")
    _time_batches(server, batches)
    batch_independence(server, batches, "policy cuda")
    return counts, {"params": params, "batches": batches, "plain": plain,
                    "outs": outs}


def _time_batches(server, batches):
    from repro_torch.serve.profile import wall_per_batch

    for task, imgs in batches:
        wall = statistics.median(wall_per_batch(server, imgs, task, reps=5,
                                                warmup=0))
        print(f"  {task}: {wall * 1e3:.3f} ms per batch of {BATCH} (median "
              f"of 5, host wall to the result on the host), "
              f"{BATCH / wall:.1f} img/s")


def fused_path(ctx, units):
    """The 16 requests again, the routed expert layers through moe_fused."""
    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import cosine
    from repro_torch.serve.vision import M3ViTServer

    policy = ops.policy_named("cuda").with_impls(moe_ffn="cuda_fused")
    server = M3ViTServer(replace(MV.CONFIG, policy=policy), ctx["params"])
    batches = ctx["batches"]
    print("  policy cuda with moe_ffn=cuda_fused: the same 16 requests")
    for task, imgs in batches * 3:          # warm-up, not counted
        server.infer(imgs, task)
    _m3vit_twins(server, batches, "policy cuda + moe_ffn=cuda_fused", units)
    torch.cuda.synchronize()

    reset_launch_counts()
    ops.reset_dispatch_report()
    outs = {task: server.infer(imgs, task) for task, imgs in batches}
    counts = launch_counts()
    report = ops.dispatch_report()
    variants = read_variants("the 16 requests (fused)")

    for task, imgs in batches:
        y = outs[task]
        if not np.isfinite(y).all():
            raise AssertionError(f"{task}: fused output not finite")
        cos = cosine(torch.from_numpy(y),
                     torch.from_numpy(ctx["plain"].infer(imgs, task)))
        print(f"  {task}: cosine vs plain eager/blocked/lut policy on the "
              f"card {cos:.6f} (>= 0.999: {'ok' if cos >= 0.999 else 'FAIL'})")
        if cos < 0.999:
            raise AssertionError(f"{task}: fused cosine {cos} < 0.999")
    print(f"  launches over the 16 requests: {json.dumps(counts)}")
    n_moe = 2 * (MV.CONFIG.num_layers // 2)        # two forwards
    if variants["moe_fused"] != {"tc": n_moe, "simt": 0}:
        raise AssertionError(f"moe_fused variants {variants['moe_fused']}: "
                             f"all {n_moe} launches must take tc")
    if counts["moe_fused"] != n_moe or counts["moe_gemm"] \
            or counts["gelu_lut"] or not counts["unified_linear"] \
            or not counts["flash_attention"]:
        raise AssertionError(f"fused path launches: {counts} (moe_fused "
                             f"must be {n_moe}, moe_gemm and gelu_lut 0)")
    entry = report.get("moe_ffn", {})
    if entry.get("hits") != {"cuda_fused": n_moe} or entry.get("fallbacks") \
            or entry.get("modes") != {"cuda_fused": {"cuda": n_moe}}:
        raise AssertionError(f"dispatch report for moe_ffn: {entry}")
    print(f"  dispatch report moe_ffn: {json.dumps(entry)}")
    _time_batches(server, batches)
    batch_independence(server, batches, "policy cuda + moe_ffn=cuda_fused")
    return counts


def batch_independence(server, batches, label):
    """Frame 0 of each task served alone and at batch 2 and 4 must give
    the bits it gets at batch 8 (the other frames of a batch are other
    images)."""
    for task, imgs in batches:
        full = server.infer(imgs, task)[0]
        diffs = {b: float(np.abs(server.infer(imgs[:b], task)[0]
                                 - full).max()) for b in (1, 2, 4)}
        print(f"  {label}, {task}: frame 0 at batch 1, 2, 4 against batch "
              f"{len(imgs)}: max abs diff {json.dumps(diffs)}")
        if any(diffs.values()):
            raise AssertionError(f"{label}, {task}: frame 0 depends on its "
                                 f"batch: {diffs}")


def paged_path(ctx):
    """The 16 requests through expert paging under ``cuda``: 8 of the 16
    experts of each MoE layer resident, synchronous, then through the
    copy-stream TransferEngine, then under a budget of four experts'
    bytes.  Every output must equal the all-resident ``cuda`` run's bit
    for bit; the waves run moe_gemm (all on tc) and gelu_lut.  These runs'
    launches are checked and printed here and stay out of phase 5, which
    times the same kernels at the same per-queue shapes."""
    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                     variant_counts)
    from repro_torch.serve.vision import M3ViTServer

    cfg = replace(MV.CONFIG, policy=ops.policy_named("cuda"))
    batches, want = ctx["batches"], ctx["outs"]
    # each run's arguments from the bytes of one expert, which the first
    # run's cache reports
    runs = (("synchronous, resident_fraction 0.5",
             lambda _: dict(resident_fraction=0.5)),
            ("asynchronous (TransferEngine), resident_fraction 0.5",
             lambda _: dict(resident_fraction=0.5, async_paging=True)),
            ("asynchronous, budget of four experts' bytes",
             lambda nbytes: dict(async_paging=True,
                                 expert_budget_bytes=4 * nbytes)))
    n_moe = MV.CONFIG.num_layers // 2
    per_expert = 0
    for label, make in runs:
        server = M3ViTServer(cfg, ctx["params"], **make(per_expert))
        layer = next(iter(server.paged.values()))
        per_expert = layer.cache.stats()["paged_expert_bytes"]
        for task, imgs in batches:          # warm-up, not counted
            server.infer(imgs, task)
        torch.cuda.synchronize()
        server.reset_stats()
        reset_launch_counts()
        ops.reset_dispatch_report()
        outs = {task: server.infer(imgs, task) for task, imgs in batches}
        counts = launch_counts()
        variants = variant_counts()
        report = ops.dispatch_report()
        stats = server.cache_stats()
        waves = [len(p.last_timeline) for p in server.paged.values()]
        print(f"  paged, {label}: {layer.cache.max_resident} of "
              f"{MV.CONFIG.moe.num_experts} experts resident per layer, "
              f"{per_expert} bytes an expert")
        for task, _ in batches:
            if not np.array_equal(outs[task], want[task]):
                raise AssertionError(
                    f"paged {label}, {task}: output differs from the "
                    f"all-resident cuda run (max abs diff "
                    f"{float(np.abs(outs[task] - want[task]).max())})")
        print(f"    outputs of both tasks bit-identical to the all-resident "
              f"cuda run")
        print(f"    launches over the 16 requests: {json.dumps(counts)}; "
              f"moe_gemm variants {json.dumps(variants['moe_gemm'])}")
        if not (counts["moe_gemm"] and counts["gelu_lut"]
                and counts["unified_linear"] and counts["flash_attention"]) \
                or counts["moe_fused"] or variants["moe_gemm"]["simt"] \
                or variants["moe_gemm"]["tc"] != counts["moe_gemm"]:
            raise AssertionError(f"paged {label}: launches {counts}, "
                                 f"moe_gemm variants {variants['moe_gemm']}")
        for op in ("linear", "attention", "moe_grouped_gemm", "activation"):
            entry = report.get(op, {})
            if entry.get("fallbacks") or entry.get("modes", {}).get(
                    "cuda") != {"cuda": entry.get("hits", {}).get("cuda", -1)}:
                raise AssertionError(f"paged dispatch report for {op}: "
                                     f"{entry}")
        print(f"    dispatch report: every linear, attention, "
              f"moe_grouped_gemm and activation on the card's kernels "
              f"({json.dumps({op: report[op]['hits'] for op in report})})")
        print(f"    waves per MoE layer (last forward): {waves}; cache over "
              f"the 2 batches: hits {stats['hits']}, misses "
              f"{stats['misses']}, evictions {stats['evictions']}, hit rate "
              f"{stats['hit_rate']:.4f}, {stats['bytes_paged'] / 2:.0f} "
              f"bytes paged per batch")
        if server.engine is not None:
            if not stats["hidden_s"] > 0:
                raise AssertionError(f"paged {label}: no copy time hidden "
                                     f"behind compute: {stats}")
            print(f"    transfers: stall {stats['stall_s'] * 1e3:.3f} ms, "
                  f"hidden {stats['hidden_s'] * 1e3:.3f} ms, overlap ratio "
                  f"{stats['overlap_ratio']:.4f} over the 2 batches")
        if len(waves) != n_moe:
            raise AssertionError(f"paged {label}: {len(waves)} paged layers")
        server.reset_stats()
        _time_batches(server, batches)
        if server.engine is not None:
            stats = server.cache_stats()
            print(f"    over the timed batches: stall "
                  f"{stats['stall_s'] * 1e3:.3f} ms, hidden "
                  f"{stats['hidden_s'] * 1e3:.3f} ms, overlap ratio "
                  f"{stats['overlap_ratio']:.4f}, hit rate "
                  f"{stats['hit_rate']:.4f}")


# ------------------------------------------------------------ phase 4


def lm_path(units):
    """Llama-3.2-1B at full width and depth: prefill + 32 decode steps."""
    import time

    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import cosine
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.train.step import make_serve_step

    policy = ops.policy_named("cuda").with_impls(attention_decode="cuda_fused")
    cfg = LL.CONFIG
    t0 = time.perf_counter()
    params = LM.init_params(0, cfg)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.values())
    print(f"  Llama-3.2-1B {cfg.num_layers} layers d={cfg.d_model} "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.dtype}: "
          f"{n_params / 1e9:.3f} B parameters from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(cfg, params, ServeConfig(max_len=LM_MAX_LEN,
                                                    policy=policy))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT))).cuda()
    engine.generate(prompts, 2)               # warm-up, not counted
    torch.cuda.synchronize()

    reset_launch_counts()
    ops.reset_dispatch_report()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, LM_NEW)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    report = ops.dispatch_report()
    read_variants("the generate call")
    print(f"  {LM_BATCH} prompts of {LM_PROMPT} tokens, {LM_NEW} greedy "
          f"tokens each: {wall * 1e3:.1f} ms host wall, "
          f"{LM_BATCH * LM_NEW / wall:.1f} tokens/s")
    print(f"  launches over the generate call: {json.dumps(counts)}")
    if tokens.shape != (LM_BATCH, LM_NEW) or not (
            (tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"generated tokens {tokens.shape} out of range")
    if counts["decode_fused"] != cfg.num_layers * LM_NEW \
            or not counts["unified_linear"] or not counts["flash_attention"]:
        raise AssertionError(f"LM path launches: {counts} (decode_fused must "
                             f"be {cfg.num_layers * LM_NEW})")
    hits = {"linear": "cuda", "attention": "cuda",
            "attention_decode": "cuda_fused"}
    for op, impl in hits.items():
        entry = report.get(op, {})
        n = entry.get("hits", {}).get(impl, -1)
        if entry.get("fallbacks") or entry.get("modes") != {impl: {"cuda": n}}:
            raise AssertionError(f"dispatch report for {op}: {entry}")
    print(f"  dispatch report: {json.dumps(report)}")

    # the prefill and every decode step again, teacher-forced on the
    # generated tokens, under the kernel policy and the plain one; the
    # first prefill and the kernel policy's decode steps are the counted
    # generate call's uncounted twin, their launches recorded
    plain_prefill, plain_decode = make_serve_step(
        replace(cfg, policy=ops.policy_named("eager")))
    prefill, decode = engine.steps()
    toks = torch.from_numpy(tokens).long().cuda()
    prefill_calls, decode_calls = {}, {}
    cosines, step_ms, prefill_ms = [], [], []
    with torch.inference_mode():
        for rep in range(3):
            state = LM.init_state(cfg, LM_BATCH, LM_MAX_LEN)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded_launches(prefill_calls if rep == 0 else {}):
                logits, state = prefill(engine.params, prompts, state)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        pstate = LM.init_state(cfg, LM_BATCH, LM_MAX_LEN)
        plain, pstate = plain_prefill(engine.params, prompts, pstate)
        for i in range(LM_NEW):
            if not torch.equal(torch.argmax(logits, -1), toks[:, i]):
                raise AssertionError(f"step {i}: the replayed logits do not "
                                     "give back the generated tokens")
            cosines.append(cosine(logits, plain))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded_launches(decode_calls):
                logits, state = decode(engine.params, toks[:, i:i + 1],
                                       state, LM_PROMPT + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            plain, pstate = plain_decode(engine.params, toks[:, i:i + 1],
                                         pstate, LM_PROMPT + i)
        cosines.append(cosine(logits, plain))
    print(f"  logits vs the plain eager policy on the card, teacher-forced: "
          f"prefill cosine {cosines[0]:.6f}, decode steps min "
          f"{min(cosines[1:]):.6f} (>= 0.999: "
          f"{'ok' if min(cosines) >= 0.999 else 'FAIL'})")
    if min(cosines) < 0.999:
        raise AssertionError(f"LM logits cosine {min(cosines)} < 0.999")
    print(f"  prefill {statistics.median(prefill_ms):.3f} ms (median of 3, "
          f"B={LM_BATCH} x {LM_PROMPT} tokens); decode "
          f"{statistics.median(step_ms):.3f} ms per step (median of "
          f"{LM_NEW}, B={LM_BATCH}, host wall to a synchronized card)")
    units.append(Unit(f"Llama-3.2-1B prefill, B={LM_BATCH} x {LM_PROMPT} "
                      f"tokens", 1, prefill_calls))
    units.append(Unit(f"Llama-3.2-1B decode step, B={LM_BATCH}, cache "
                      f"{LM_PROMPT + 1}-{LM_PROMPT + LM_NEW} keys", LM_NEW,
                      decode_calls))
    return counts


# ------------------------------------------------------------ phase 5


@dataclass
class Case:
    """One recorded launch, ready to check and time."""

    key: object                 # launches with equal keys share one reading
    label: str
    kernel: Callable
    plain: Callable
    library: Optional[Callable]
    nbytes: float
    flops: float
    peak: torch.dtype           # the type whose peak rate bounds the flops
    tol: Optional[Callable] = dict    # -> tolerance keywords; None: exact
    after: Optional[Callable] = None  # further check of the kernel's output
    staged: Optional[Callable] = None  # moe_fused: the staged cuda path
    variant: Optional[str] = None     # the planned kernel variant


def _linear_case(args) -> Case:
    from repro_torch.core.gelu import device_table
    from repro_torch.kernels import unified_linear as kul

    x, w, b, act, use_lut, step, rng = args
    m, k = x.shape
    n = w.shape[1]
    kw = dict(activation=act, use_lut=use_lut, step_log2=step, lut_range=rng)
    lut = bool(use_lut and act in ("gelu", "silu"))
    moved = (m * k + k * n + m * n) * x.element_size() \
        + (_nbytes(b) if b is not None else 0) \
        + (_nbytes(device_table(act, step, rng, x.device)) if lut else 0)
    plan = kul.plan_for(x, w)
    return Case(
        key=("linear", m, k, n, x.dtype, act, lut, b is not None),
        label=f"M={m} K={k} N={n} {act or 'none'}{'-lut' if lut else ''}"
              f"{' +bias' if b is not None else ''} {_dt(x)} "
              f"[{_plan_label(plan)}]", variant=plan.variant,
        kernel=lambda: kul.unified_linear(x, w, b, **kw),
        plain=lambda: kul.unified_linear_plain(x, w, b, **kw),
        library=lambda: torch.matmul(x, w), nbytes=moved,
        flops=2.0 * m * n * k, peak=x.dtype,
        tol=lambda: dict(
            lut_pre=kul.unified_linear_plain(x.float(), w.float(), b)
            if lut else None,
            kind=act if lut else "gelu", step_log2=step, lut_range=rng))


def _attention_case(args) -> Case:
    from repro_torch.core.attention import allowed_keys
    from repro_torch.kernels import flash_attention as kfa

    q, k, v, causal, window, q_offset, scale = args
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    ok = allowed_keys(torch.arange(sq, device=q.device) + q_offset,
                      torch.arange(skv, device=q.device), causal, window)
    pairs, keys = int(ok.sum()), int(ok.any(dim=0).sum())
    mask = ok if causal or window is not None else None
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    plan = kfa.plan_for(q)
    return Case(
        key=("attention", tuple(q.shape), tuple(k.shape), q.dtype, causal,
             window, q_offset),
        label=f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} "
              f"{'causal' if causal else 'non-causal'} q_offset={q_offset} "
              f"window={window} {_dt(q)} ({keys} keys visible) "
              f"[{_attn_label(plan)}]", variant=plan.variant,
        kernel=lambda: kfa.flash_attention(q, k, v, **kw),
        plain=lambda: kfa.flash_attention_plain(q, k, v, **kw),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=hq != hkv),
        nbytes=(2 * q.numel() + 2 * b * hkv * keys * d) * q.element_size(),
        flops=4.0 * b * hq * pairs * d, peak=q.dtype)


def _activation_case(args) -> Case:
    from repro_torch.core.gelu import device_table
    from repro_torch.kernels import gelu_lut as kgl

    x, kind, step, rng = args
    return Case(
        key=("lut", tuple(x.shape), x.dtype, kind),
        label=f"{tuple(x.shape)} {kind} {_dt(x)}",
        kernel=lambda: kgl.lut_activation(x, kind, step_log2=step,
                                          lut_range=rng),
        plain=lambda: kgl.lut_activation_plain(x, kind, step_log2=step,
                                               rng=rng),
        library=None,
        nbytes=2 * _nbytes(x) + _nbytes(device_table(kind, step, rng,
                                                     x.device)),
        flops=10.0 * x.numel(), peak=torch.float32, tol=None)


def _moe_gemm_case(args) -> Case:
    from repro_torch.kernels import moe_gemm as kmg

    buf, w, sizes = args
    g, e, c, d = buf.shape
    f = w.shape[2]
    live = int(sizes.sum())
    active = int((sizes > 0).any(dim=0).sum())
    xb = buf.transpose(0, 1).reshape(e, g * c, d).contiguous()
    s = buf.element_size()
    plan = kmg.plan_for(buf, w)
    return Case(
        key=("moe_gemm", tuple(buf.shape), tuple(w.shape), buf.dtype,
             tuple(sizes.flatten().tolist())),
        label=f"G={g} E={e} C={c} D={d} F={f} {_dt(buf)}: {live} of "
              f"{g * e * c} rows live, {active} experts used "
              f"[{_plan_label(plan)}]", variant=plan.variant,
        kernel=lambda: kmg.moe_gemm(buf, w, sizes),
        plain=lambda: kmg.moe_gemm_plain(buf, w, sizes),
        library=lambda: torch.bmm(xb, w),
        nbytes=live * d * s + active * d * f * s + g * e * c * f * s
        + _nbytes(sizes),
        flops=2.0 * live * d * f, peak=buf.dtype,
        after=lambda got: _zero_tails("moe_gemm", got, sizes))


_EXPERT_WEIGHTS = {"gelu": ("w1", "b1", "w2", "b2"),
                   "swiglu": ("wg", "wu", "wd")}


def _moe_fused_case(args) -> Case:
    from repro_torch import ops
    from repro_torch.core import routing as R
    from repro_torch.core.gelu import device_table
    from repro_torch.core.moe import MoEConfig
    from repro_torch.kernels import moe_fused as kmf
    from repro_torch.kernels.compare import moe_lut_allowance

    (x, params, expert, gate, position, valid, sizes, kind, capacity,
     use_lut, step, rng) = args
    g, t, d = x.shape
    k, e = expert.shape[-1], sizes.shape[-1]
    weights = [params[n] for n in _EXPERT_WEIGHTS[kind]]
    f = weights[0].shape[-1]
    live, dropped = int(sizes.sum()), int((~valid).sum())
    active = int((sizes > 0).any(dim=0).sum())
    plan = kmf.plan_for(x, params, kind, capacity, device_table(
        "silu" if kind == "swiglu" else "gelu", step, rng,
        x.device) if use_lut else None)
    if plan.variant == "tc":    # 64 packed rows of one expert a block
        per_e = sizes.clamp(0, capacity).sum(dim=0)
        ran = int(((per_e + 63) // 64).sum()) * plan.grid[1]
    else:                       # 32 rows of one (group, expert) a block
        ran = int(((sizes.clamp(0, capacity) + 31) // 32).sum())
    call = (x, params, expert, gate, position, valid, sizes)
    kw = dict(kind=kind, capacity=capacity, use_lut=use_lut, step_log2=step,
              lut_range=rng)
    mcfg = MoEConfig(d_model=d, d_ff=f, num_experts=e, top_k=k,
                     expert_kind=kind)
    routing = R.Routing(expert=expert, gate=gate, position=position,
                        valid=valid, probs=None)
    staged_policy = ops.policy_named("cuda")

    def staged():
        with ops.use_policy(staged_policy):
            return ops.dispatch("moe_ffn", x, params, routing, sizes,
                                cfg=mcfg, capacity=capacity)

    per_expert = sum(w[0].numel() * w.element_size() for w in weights)
    return Case(
        key=None,               # every layer's routing is its own
        label=f"G={g} T={t} E={e} top-{k} C={capacity} d={d} f={f} "
              f"{kind}{'-lut' if use_lut else ''} {_dt(x)}: {live} slots "
              f"live, {dropped} dropped, {active} experts used, longest "
              f"queue {int(sizes.max())}, {ran} of {plan.blocks or ran} "
              f"blocks ran [{_fused_label(plan)}]", variant=plan.variant,
        kernel=lambda: kmf.fused_moe_ffn(*call, **kw),
        plain=lambda: kmf.fused_moe_ffn_plain(*call, **kw),
        library=None, staged=staged,
        nbytes=2 * _nbytes(x) + active * per_expert
        + _nbytes(expert, gate, position, valid, sizes),
        flops=(4.0 if kind == "gelu" else 6.0) * live * d * f, peak=x.dtype,
        tol=lambda: dict(extra=moe_lut_allowance(
            x, params, expert, gate, valid, kind=kind, step_log2=step,
            lut_range=rng) if use_lut else None))


def _decode_case(args) -> Case:
    from repro_torch.kernels import decode_fused as kdf

    q, k, v, cl, window, scale = args
    b, hq, _, d = q.shape
    hkv, smax = k.shape[1], k.shape[2]
    kpos = torch.arange(smax, device=q.device)[None, :]
    ok = kpos < cl[:, None]
    if window is not None:
        ok = ok & (kpos > cl[:, None] - 1 - window)
    n_keys = int(ok.sum())
    lengths = cl.tolist()
    kw = dict(window=window, scale=scale)
    return Case(
        key=("decode", tuple(q.shape), tuple(k.shape), q.dtype, window,
             tuple(lengths)),
        label=f"B={b} Hq={hq} Hkv={hkv} Smax={smax} D={d} cache_len "
              f"{min(lengths)}..{max(lengths)} window={window} {_dt(q)}",
        kernel=lambda: kdf.fused_decode_attention(q, k, v, cl, **kw),
        plain=lambda: kdf.fused_decode_attention_plain(q, k, v, cl, **kw),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=ok[:, None, None, :], scale=scale,
            enable_gqa=hq != hkv),
        nbytes=2 * _nbytes(q) + 2 * n_keys * hkv * d * q.element_size()
        + _nbytes(cl),
        flops=4.0 * n_keys * hq * d, peak=q.dtype)


CASES = {"unified_linear": _linear_case, "flash_attention": _attention_case,
         "gelu_lut": _activation_case, "moe_gemm": _moe_gemm_case,
         "moe_fused": _moe_fused_case, "decode_fused": _decode_case}


def _check_case(name, case) -> tuple[float, float, float]:
    """Hold one recorded launch against its plain version, and time the
    launch alone (replayed on the same operands, which stay warm in L2);
    (max error, ms alone, bound ms)."""
    got, want = case.kernel(), case.plain()
    if case.tol is None:
        err = check_exact(name, case.label, got, want)
    else:
        err = check(name, case.label, got, want, want.dtype, **case.tol())
    if case.after is not None:
        case.after(got)
    del got, want
    alone = time_ms(case.kernel)
    t_bytes, t_ops = bound_ms(case.nbytes, case.flops, case.peak)
    print(f"    alone {alone:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    return err, alone, (t_bytes, t_ops)


def _in_order(fns):
    def run():
        for fn in fns:
            fn()
    return run


def _run_reading(run) -> dict:
    """One run's recorded launches replayed in their order: the kernels,
    the plain versions, the library calls (and the staged path) each as one
    CUDA graph, so every launch meets its own operands as in the path."""
    t = {"ms": time_ms(_in_order([c.kernel for c in run]), calls=1),
         "plain_ms": time_ms(_in_order([c.plain for c in run]), calls=1),
         "library_ms": None}
    if all(c.library is not None for c in run):
        t["library_ms"] = time_ms(_in_order([c.library for c in run]),
                                  calls=1)
    if all(c.staged is not None for c in run):
        t["staged_cuda_ms"] = time_ms(_in_order([c.staged for c in run]),
                                      calls=1)
    return t


def _add(total: dict, t: dict) -> None:
    for k, v in t.items():
        total[k] = None if v is None else (total.get(k) or 0.0) + v


def _entry(total: dict) -> dict:
    out = {k: total[k] for k in ("ms", "plain_ms", "bound_ms")}
    out["bound_by"] = ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                       else "operations")
    out["library_ms"] = total["library_ms"]
    for k in ("staged_cuda_ms", "alone_ms"):
        if k in total:
            out[k] = total[k]
    return out


def path_records(units, counted) -> list[dict]:
    """Each kernel's JSON entry from the recorded launches of the main
    paths, whose number must equal the counted launches.  Every distinct
    launch (by shape and data) is checked and timed alone once; every
    distinct run is timed in order once."""
    from repro_torch.kernels import KERNELS

    checked: dict = {}      # case key -> (err, alone ms, bound parts)
    timed: dict = {}        # run's case keys -> in-order reading
    records = []
    for name in KERNELS:
        recorded = sum(len(u.calls.get(name, ())) for u in units)
        if recorded != counted[name]:
            raise AssertionError(f"{name}: {recorded} launches recorded in "
                                 f"the twins, {counted[name]} counted")
        rows, total, max_err, variants = [], {}, 0.0, {}
        for u in units:
            cases = [CASES[name](args) for args in u.calls.get(name, ())]
            if not cases:
                continue
            if len(cases) % u.runs:
                raise AssertionError(f"{name}: {len(cases)} launches over "
                                     f"{u.runs} runs of {u.label}")
            unit_total = {"alone_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                          "bound_ms": 0.0}
            for case in cases:
                if case.key is None or case.key not in checked:
                    reading = _check_case(name, case)
                    if case.key is not None:
                        checked[case.key] = reading
                else:
                    reading = checked[case.key]
                err, alone, (t_bytes, t_ops) = reading
                max_err = max(max_err, err)
                _add(unit_total, {"alone_ms": alone, "bytes_ms": t_bytes,
                                  "ops_ms": t_ops,
                                  "bound_ms": max(t_bytes, t_ops)})
            per = len(cases) // u.runs
            for i in range(u.runs):
                run = cases[i * per:(i + 1) * per]
                keys = tuple(c.key for c in run)
                if None in keys or keys not in timed:
                    reading = _run_reading(run)
                    if None not in keys:
                        timed[keys] = reading
                else:
                    reading = timed[keys]
                _add(unit_total, reading)
            _add(total, unit_total)
            row = {"per": u.label, "runs": u.runs, "launches": len(cases),
                   **_entry(unit_total)}
            if cases[0].variant is not None:
                row["variants"] = {}
                for c in cases:
                    row["variants"][c.variant] = \
                        row["variants"].get(c.variant, 0) + 1
                for v, k in row["variants"].items():
                    variants[v] = variants.get(v, 0) + k
            rows.append(row)
            n = u.runs
            lib = row["library_ms"]
            print(f"  {name} per {u.label}: {per} launches, in order: kernel "
                  f"{row['ms'] / n:.4f} ms, plain {row['plain_ms'] / n:.4f} "
                  f"ms, library "
                  f"{'%.4f ms' % (lib / n) if lib is not None else 'n/a'}"
                  + (f", staged cuda path {row['staged_cuda_ms'] / n:.4f} ms"
                     if "staged_cuda_ms" in row else "")
                  + f"; alone {row['alone_ms'] / n:.4f} ms; bound "
                  f"{row['bound_ms'] / n:.4f} ms ({row['bound_by']})"
                  + (f"; variants {row['variants']}" if "variants" in row
                     else ""))
        extra = {}
        if name in COUNTED_VARIANTS:
            counted_v = {v: k for v, k in COUNTED_VARIANTS[name].items() if k}
            if variants != counted_v:
                raise AssertionError(f"{name}: recorded launches planned "
                                     f"{variants}, counters {counted_v}")
            extra["variants"] = variants
        records.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": counted[name], "max_abs_err": max_err,
                        **_entry(total), **extra,
                        "per": "every launch of the counted main-path runs",
                        "units": rows})
    return records


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs the port on an NVIDIA Hopper card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    print("phase 1: card, versions, build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"  torch {torch.__version__} CUDA {torch.version.cuda} python "
          f"{sys.version.split()[0]}; TF32 off for matmul and cuDNN (plain "
          f"versions run in full float32)")
    secs = build.build_seconds()
    print(f"  kernels built and loaded in {secs:.1f} s (nvcc "
          f"{' '.join(build.NVCC_FLAGS)})")
    log = build.build_log()
    for line in log.splitlines():
        if (any(w in line for w in ("entry function", "registers", "spill",
                                    "serialized"))
                and "C7519" not in line) or line.startswith("=="):
            print("   " + line.strip())
    # ptxas serializes the wgmmas of a kernel that issues one under a
    # branch (C7518) or runs short of registers (C7512); the fused MoE
    # source holds no other wgmma kernel than moe_fused_tc_kernel
    fused_log = log.split("== moe_fused.cu", 1)[-1].split("\n== ", 1)[0]
    if "C7518" in fused_log or "serialized" in fused_log:
        raise AssertionError("moe_fused_tc_kernel: ptxas serialized its "
                             "wgmmas")
    print("  moe_fused.cu: no wgmma serialization (C7518, C7512) in its "
          "build log")
    hgmma = build.sass_counts("HGMMA")
    for kernel, n in (("unified_linear_tc_kernel", 12),
                      ("moe_gemm_tc_kernel", 12),
                      ("flash_attention_tc_kernel", 2),
                      ("moe_fused_tc_kernel", 12)):
        found = {k: v for k, v in hgmma.items() if kernel in k}
        if len(found) != n:
            raise AssertionError(f"{kernel}: {len(found)} of {n} instances "
                                 f"issue HGMMA in their SASS")
        print(f"  {kernel}: HGMMA in the SASS of all {n} instances "
              f"({min(found.values())}..{max(found.values())} each)")

    print("phase 2: kernels against their plain versions, made-up inputs")
    for run_checks in (check_unified_linear, check_flash_attention,
                       check_gelu_lut, check_moe_gemm, check_moe_fused,
                       check_decode_fused):
        run_checks()

    units: list[Unit] = []
    print("phase 3: main path, M3ViT serving")
    counts, ctx = main_path(units)
    fused_counts = fused_path(ctx, units)
    paged_path(ctx)

    print("phase 4: LM path, Llama-3.2-1B serving")
    lm_counts = lm_path(units)
    counted = {n: counts[n] + fused_counts[n] + lm_counts[n] for n in counts}

    print("phase 5: the kernels at the main paths' own inputs")
    records = path_records(units, counted)

    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
