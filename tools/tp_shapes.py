#!/usr/bin/env python3
"""The three kernels of the tensor-parallel serving path on one card, at
the shapes one rank of DeepSeek-67B, of RecurrentGemma-9B and of
xLSTM-350M over a (1, 4) mesh gives them: each launch held against its plain version
(``chip_smoke.check``), then timed beside its plain version, one PyTorch
library call on the same inputs and the card's bound for the same work,
next to the card's name and power limit.

    python3 tools/tp_shapes.py [--out build/tp_shapes.json]
    python3 tools/tp_shapes.py --bytes     # no card: weight bytes a rank

``--bytes`` prints, from the shapes on ``meta`` (``serve.engine.
local_params`` over a device-free mesh), the bf16 weight bytes a rank of
RecurrentGemma-9B holds at full depth over (1, 2) and (1, 4), with its
RG-LRU mixers split and as if they stayed whole on every rank, and the
mixer weight bytes (the ``mlstm`` and ``slstm`` leaves) a rank of
xLSTM-350M holds at full depth over (1, 2) and (1, 4) against the
whole.

Shapes (bf16; decode is 8 rows, prefill 8 x 128 = 1024):

* ``unified_linear`` column blocks of ``attn/wq`` (8192 x 2048 of 8192),
  ``attn/wk`` (8192 x 256 of 1024), ``mlp/wg`` (8192 x 5504 of 22016) and
  ``head/w`` (8192 x 25600 of 102400), summed in the whole weight's order
  (``order_n``); row blocks of ``attn/wo`` (2048 x 8192) and ``mlp/wd``
  (5504 x 8192) writing float32 partials; library: ``torch.matmul``
  (``torch.mm(out_dtype=float32)`` for the row blocks where this PyTorch
  has it);
* ``flash_attention``: a prefill's 16 of 64 q heads over 2 of 8 KV heads,
  128 tokens, head_dim 128, causal; library:
  ``scaled_dot_product_attention`` (``enable_gqa``);
* ``decode_fused``: one step's 16 q heads over a 512-slot cache of 2 KV
  heads with per-slot lengths 129..160; library: SDPA over the cache with
  a length mask;
* RecurrentGemma-9B's RG-LRU: ``unified_linear`` column blocks of
  ``rglru/w_up`` (4096 x 1024 of 4096) and ``rglru/w_up2`` with its GELU
  epilogue (the ``cuda`` policy's; library: ``gelu(torch.matmul)``), and
  the float32 row block of ``rglru/w_down`` (1024 x 4096),
  at the same 8 and 1024 rows;
* xLSTM-350M's mLSTM: ``unified_linear`` column blocks of ``mlstm/w_up``
  and ``mlstm/w_gates`` (1024 x 512 of 2048) and of ``mlstm/w_qkv``
  (2048 x 1536 of 6144, the table's contiguous block), and the float32
  row block of ``mlstm/w_down`` (512 x 1024), at the same 8 and 1024
  rows.
"""

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402

D, HQ, HKV, HD, FF, VOCAB, TP = 8192, 64, 8, 128, 22016, 102400, 4
B, S, SMAX = 8, 128, 512
COLUMNS = (("wq", HQ * HD), ("wk", HKV * HD), ("wg", FF), ("head", VOCAB))
ROWS = (("wo", HQ * HD), ("wd", FF))
RG_D = RG_W = 4096        # RecurrentGemma-9B's d_model and RG-LRU width
XL_D = 1024               # xLSTM-350M's d_model (the mLSTM's width 2d)


def _row(name, shape, ms, plain_ms, lib_ms, nbytes, flops, err, variant):
    by_bytes, by_ops = C.bound_ms(nbytes, flops, torch.bfloat16)
    rec = {"kernel": name, "shape": shape, "variant": variant,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    print(f"  {name} {shape} [{variant}]: {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, library {lib_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}), {rec['bound_ms'] / ms:.2f} of the bound")
    return rec


def _mm_f32(x, w):
    """bf16 operands, float32 product out: ``torch.mm(out_dtype=)`` where
    this PyTorch has it, else ``torch.mm`` (its bf16 out, then widened)."""
    try:
        return torch.mm(x, w, out_dtype=torch.float32)
    except TypeError:
        return torch.mm(x, w).float()


def _mm_f32_name() -> str:
    try:
        x = torch.zeros((1, 1), dtype=torch.bfloat16, device="cuda")
        torch.mm(x, x, out_dtype=torch.float32)
        return "torch.mm(out_dtype=float32)"
    except TypeError:
        return "torch.mm(bf16 out).float()"


def linear_rows() -> list:
    from repro_torch.kernels import unified_linear as kul

    out = []
    for m in (B, B * S):
        x = C.randn((m, D), torch.bfloat16, seed=1)
        for name, n in COLUMNS:
            nb = n // TP
            w = C.randn((D, nb), torch.bfloat16, scale=D ** -0.5, seed=2)
            plan = kul.plan_for(x, w, order_n=n)
            err = C.check("unified_linear", f"{name} column block M={m}",
                          kul.unified_linear(x, w, order_n=n),
                          kul.unified_linear_plain(x, w), torch.bfloat16)
            out.append(_row(
                "unified_linear", f"{name} M={m} K={D} N={nb} of {n}",
                C.time_ms(lambda: kul.unified_linear(x, w, order_n=n)),
                C.time_ms(lambda: kul.unified_linear_plain(x, w)),
                C.time_ms(lambda: torch.matmul(x, w)),
                C._nbytes(x, w) + m * nb * 2, 2.0 * m * D * nb, err,
                C._plan_label(plan)))
        for name, k in ROWS:
            kb = k // TP
            xr = C.randn((m, kb), torch.bfloat16, seed=3)
            w = C.randn((kb, D), torch.bfloat16, scale=kb ** -0.5, seed=4)
            plan = kul.plan_for(xr, w)
            f32 = torch.float32
            err = C.check("unified_linear", f"{name} row block M={m}",
                          kul.unified_linear(xr, w, out_dtype=f32),
                          kul.unified_linear_plain(xr, w, out_dtype=f32),
                          torch.float32)
            out.append(_row(
                "unified_linear", f"{name} M={m} K={kb} of {k} N={D} "
                f"float32 out",
                C.time_ms(lambda: kul.unified_linear(xr, w, out_dtype=f32)),
                C.time_ms(lambda: kul.unified_linear_plain(
                    xr, w, out_dtype=f32)),
                C.time_ms(lambda: _mm_f32(xr, w)),
                C._nbytes(xr, w) + m * D * 4, 2.0 * m * kb * D, err,
                C._plan_label(plan)))
    return out


def rglru_rows() -> list:
    """RecurrentGemma-9B's RG-LRU projections at one rank's (1, 4)
    blocks."""
    from repro_torch import ops
    from repro_torch.kernels import unified_linear as kul

    pol = ops.policy_named("cuda")
    geo = dict(step_log2=pol.lut_step_log2, lut_range=pol.lut_range)
    out = []
    wb = RG_W // TP
    for m in (B, B * S):
        x = C.randn((m, RG_D), torch.bfloat16, seed=11)
        w = C.randn((RG_D, wb), torch.bfloat16, scale=RG_D ** -0.5, seed=12)
        for name, act in (("rglru w_up", None), ("rglru w_up2", "gelu")):
            lut = bool(act and pol.lut_activations)
            kw = dict(activation=act, use_lut=lut, **geo)
            pre = kul.unified_linear_plain(x.float(), w.float()) \
                if lut else None
            plan = kul.plan_for(x, w, order_n=RG_W)
            err = C.check("unified_linear", f"{name} column block M={m}",
                          kul.unified_linear(x, w, order_n=RG_W, **kw),
                          kul.unified_linear_plain(x, w, **kw),
                          torch.bfloat16, lut_pre=pre, kind=act or "gelu",
                          **geo)
            lib = (lambda: torch.matmul(x, w)) if act is None else (
                lambda: torch.nn.functional.gelu(torch.matmul(x, w)))
            out.append(_row(
                "unified_linear", f"{name} M={m} K={RG_D} N={wb} of {RG_W}"
                f"{' gelu' if act else ''}",
                C.time_ms(lambda: kul.unified_linear(x, w, order_n=RG_W,
                                                     **kw)),
                C.time_ms(lambda: kul.unified_linear_plain(x, w, **kw)),
                C.time_ms(lib), C._nbytes(x, w) + m * wb * 2,
                2.0 * m * RG_D * wb, err, C._plan_label(plan)))
        xr = C.randn((m, wb), torch.bfloat16, seed=13)
        wr = C.randn((wb, RG_D), torch.bfloat16, scale=RG_W ** -0.5, seed=14)
        f32 = torch.float32
        plan = kul.plan_for(xr, wr)
        err = C.check("unified_linear", f"rglru w_down row block M={m}",
                      kul.unified_linear(xr, wr, out_dtype=f32),
                      kul.unified_linear_plain(xr, wr, out_dtype=f32), f32)
        out.append(_row(
            "unified_linear", f"rglru w_down M={m} K={wb} of {RG_W} "
            f"N={RG_D} float32 out",
            C.time_ms(lambda: kul.unified_linear(xr, wr, out_dtype=f32)),
            C.time_ms(lambda: kul.unified_linear_plain(xr, wr,
                                                       out_dtype=f32)),
            C.time_ms(lambda: _mm_f32(xr, wr)),
            C._nbytes(xr, wr) + m * RG_D * 4, 2.0 * m * wb * RG_D, err,
            C._plan_label(plan)))
    return out


def xlstm_rows() -> list:
    """xLSTM-350M's mLSTM projections at one rank's (1, 4) blocks."""
    from repro_torch.kernels import unified_linear as kul

    di = 2 * XL_D
    out = []
    for m in (B, B * S):
        x = C.randn((m, XL_D), torch.bfloat16, seed=21)
        xu = C.randn((m, di), torch.bfloat16, seed=22)
        for name, xin, k, n in (("mlstm w_up", x, XL_D, di),
                                ("mlstm w_gates", x, XL_D, di),
                                ("mlstm w_qkv", xu, di, 3 * di)):
            nb = n // TP
            w = C.randn((k, nb), torch.bfloat16, scale=k ** -0.5, seed=23)
            plan = kul.plan_for(xin, w, order_n=n)
            err = C.check("unified_linear", f"{name} column block M={m}",
                          kul.unified_linear(xin, w, order_n=n),
                          kul.unified_linear_plain(xin, w), torch.bfloat16)
            out.append(_row(
                "unified_linear", f"{name} M={m} K={k} N={nb} of {n}",
                C.time_ms(lambda: kul.unified_linear(xin, w, order_n=n)),
                C.time_ms(lambda: kul.unified_linear_plain(xin, w)),
                C.time_ms(lambda: torch.matmul(xin, w)),
                C._nbytes(xin, w) + m * nb * 2, 2.0 * m * k * nb, err,
                C._plan_label(plan)))
        kb = di // TP
        xr = C.randn((m, kb), torch.bfloat16, seed=24)
        wr = C.randn((kb, XL_D), torch.bfloat16, scale=di ** -0.5, seed=25)
        f32 = torch.float32
        plan = kul.plan_for(xr, wr)
        err = C.check("unified_linear", f"mlstm w_down row block M={m}",
                      kul.unified_linear(xr, wr, out_dtype=f32),
                      kul.unified_linear_plain(xr, wr, out_dtype=f32), f32)
        out.append(_row(
            "unified_linear", f"mlstm w_down M={m} K={kb} of {di} "
            f"N={XL_D} float32 out",
            C.time_ms(lambda: kul.unified_linear(xr, wr, out_dtype=f32)),
            C.time_ms(lambda: kul.unified_linear_plain(xr, wr,
                                                       out_dtype=f32)),
            C.time_ms(lambda: _mm_f32(xr, wr)),
            C._nbytes(xr, wr) + m * XL_D * 4, 2.0 * m * kb * XL_D, err,
            C._plan_label(plan)))
    return out


def weight_bytes() -> dict:
    """bf16 weight bytes a rank of RecurrentGemma-9B at full depth over
    (1, 2) and (1, 4), from the shapes: its RG-LRU mixers split (this
    layout) and whole on every rank (the layout before it)."""
    from repro_torch.configs import get
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.dist.spmd import VirtualMesh
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import local_params

    cfg = get("recurrentgemma_9b")
    shapes = LM.param_specs(cfg)

    def nbytes(tree, part=""):
        return sum(t.numel() * t.element_size() for k, t in tree.items()
                   if part in k)

    out = {"whole": nbytes(shapes)}
    for tp in (2, 4):
        held = local_params(shapes, cfg, ShardingRules.for_mesh(
            VirtualMesh((1, tp), ("data", "model")), fsdp=False))
        split = nbytes(held)
        out[f"1x{tp}"] = {"split": split, "mixers_whole": split - nbytes(
            held, ".rglru.") + nbytes(shapes, ".rglru.")}
    print(f"RecurrentGemma-9B weights, bf16, {cfg.num_layers} layers: "
          f"whole {out['whole'] / 1e9:.3f} GB; a rank over "
          + "; ".join(f"{k} {v['mixers_whole'] / 1e9:.3f} GB with the "
                      f"RG-LRU mixers whole, {v['split'] / 1e9:.3f} GB "
                      f"split" for k, v in out.items() if k != "whole"))
    xl = get("xlstm_350m")
    shapes = LM.param_specs(xl)

    def mixers(tree):
        return nbytes(tree, ".mlstm.") + nbytes(tree, ".slstm.")

    out["xlstm_350m"] = {"whole": mixers(shapes)}
    for tp in (2, 4):
        held = local_params(shapes, xl, ShardingRules.for_mesh(
            VirtualMesh((1, tp), ("data", "model")), fsdp=False))
        out["xlstm_350m"][f"1x{tp}"] = mixers(held)
    x = out["xlstm_350m"]
    print(f"xLSTM-350M mixer weights (mlstm, slstm), {xl.num_layers} "
          f"layers: whole {x['whole'] / 2**20:.2f} MiB; a rank over 1x2 "
          f"{x['1x2'] / 2**20:.2f} MiB, over 1x4 {x['1x4'] / 2**20:.2f} MiB")
    return out


def attention_rows() -> list:
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import flash_attention as kfa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    hq, hkv = HQ // TP, HKV // TP
    q = C.randn((B, hq, S, HD), torch.bfloat16, seed=5)
    k = C.randn((B, hkv, S, HD), torch.bfloat16, seed=6)
    v = C.randn((B, hkv, S, HD), torch.bfloat16, seed=7)
    err = C.check("flash_attention", "16 q heads over 2 KV heads, causal",
                  kfa.flash_attention(q, k, v),
                  kfa.flash_attention_plain(q, k, v), torch.bfloat16)
    rows = [_row(
        "flash_attention", f"B={B} Hq={hq} Hkv={hkv} S={S} D={HD} causal",
        C.time_ms(lambda: kfa.flash_attention(q, k, v)),
        C.time_ms(lambda: kfa.flash_attention_plain(q, k, v)),
        C.time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)),
        C._nbytes(q, k, v, q), 4.0 * B * hq * S * S * HD / 2, err,
        C._attn_label(kfa.plan_for(q)))]
    q1 = C.randn((B, hq, 1, HD), torch.bfloat16, seed=8)
    kc = C.randn((B, hkv, SMAX, HD), torch.bfloat16, seed=9)
    vc = C.randn((B, hkv, SMAX, HD), torch.bfloat16, seed=10)
    cl = torch.arange(129, 129 + B * 4, 4, dtype=torch.int32, device="cuda")
    mask = (torch.arange(SMAX, device="cuda")[None, :] < cl[:, None])[
        :, None, None, :]
    err = C.check("decode_fused", "16 q heads over 2 KV heads, per-slot "
                  "lengths", kdf.fused_decode_attention(q1, kc, vc, cl),
                  kdf.fused_decode_attention_plain(q1, kc, vc, cl),
                  torch.bfloat16)
    live = int(cl.sum())
    rows.append(_row(
        "decode_fused", f"B={B} Hq={hq} Hkv={hkv} Smax={SMAX} D={HD} "
        f"lengths {int(cl.min())}..{int(cl.max())}",
        C.time_ms(lambda: kdf.fused_decode_attention(q1, kc, vc, cl)),
        C.time_ms(lambda: kdf.fused_decode_attention_plain(q1, kc, vc, cl)),
        C.time_ms(lambda: sdpa(q1, kc, vc, attn_mask=mask,
                               enable_gqa=True)),
        C._nbytes(q1, q1) + 2 * live * hkv * HD * 2,
        4.0 * live * hq * HD, err, "decode"))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--bytes", action="store_true",
                    help="only the weight bytes a rank, from the shapes")
    args = ap.parse_args()
    if args.bytes:
        weight_bytes()
        return
    if not torch.cuda.is_available():
        raise SystemExit("tp_shapes: runs on an NVIDIA Hopper card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    from repro_torch.kernels import build

    print(f"kernels built and loaded in {build.build_seconds():.1f} s; "
          f"DeepSeek-67B, RecurrentGemma-9B and xLSTM-350M one rank of "
          f"(1, {TP})")
    print(f"row blocks' library call: {_mm_f32_name()}")
    rows = linear_rows() + attention_rows() + rglru_rows() + xlstm_rows()
    line = {"card": smi, "tp": TP, "row_library": _mm_f32_name(),
            "rows": rows, "weight_bytes": weight_bytes()}
    print(json.dumps(line))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(line, indent=1))
    assert math.isfinite(sum(r["ms"] for r in rows))


if __name__ == "__main__":
    main()
