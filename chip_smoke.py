#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of M³ViT on one NVIDIA Hopper card (H100).

    python3 chip_smoke.py

Phases, each printing its lines:

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every ``src/repro_torch/csrc/*.cu`` kernel
   with ``nvcc`` for ``sm_90a`` (into ``build/``), with ptxas' register and
   spill report.
2. Each of the four kernels against its plain PyTorch version on the card:
   at the main path's shapes (B = 8 images) in bf16 and in float32, and at
   one ragged case; the max error beside the stated tolerance
   (``repro_torch.kernels.compare``), then the kernel's, the plain
   version's and one library call's device time (CUDA events around
   replays of a CUDA graph of 10 calls, median of 20 after warm-up; the
   library calls ``torch.matmul``, SDPA and ``torch.bmm`` are yardsticks
   only), then the least time the card could take: the larger of the
   bytes moved (each input read once, each output written once) at
   3.35 TB/s and the operations at the peak rate for the type (989 TFLOP/s
   bf16, 67 TFLOP/s float32).
3. The main path: an ``M3ViTServer`` at the full 12-layer ``CONFIG`` in
   bf16 under the ``cuda`` policy, with seeded random weights, answers 16
   requests (8 semseg, 8 depth) in batches of 8.  Output shapes and
   finiteness are checked, and each task's outputs are held to cosine
   >= 0.999 against the same forward under the plain eager/blocked/lut
   policy on the card.  Every kernel's launch count over the 16 requests
   must be > 0 and the dispatch report must show the kernels hit on the
   card.  Then each task's batch is timed: the median host wall time of 5
   calls (``repro_torch.serve.profile.wall_per_batch``).

The plain versions run in full float32: TF32 is switched off for matmuls
and for cuDNN before anything runs.  Any failed check raises; the last two
lines are the kernels' JSON record and the result line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

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
}


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


class KernelCheck:
    """One kernel's checks and timings; ``record`` is its JSON entry,
    summed over the launches of one semseg forward at B = 8."""

    def __init__(self, name: str, source: str):
        self.name, self.source = name, source
        self.max_err = 0.0
        self.ms = self.plain_ms = self.bound = 0.0
        self.library_ms: float | None = None
        self.bytes_ms = self.ops_ms = 0.0

    def check(self, label, got, want, dtype, **kw):
        from repro_torch.kernels.compare import (max_abs_err,
                                                 within_tolerance)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ok = within_tolerance(got, want, dtype, **kw)
        rule = ("float32 1e-5+1e-5|ref|" if dtype == torch.float32
                else "1 bf16 ulp + float32 tol")
        if kw.get("lut_pre") is not None:
            rule += " (+1 table step at LUT index ties)"
        print(f"  {self.name} {label}: max_abs_err {err:.3e} "
              f"tolerance {rule}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{self.name} {label}: kernel disagrees "
                                 f"with its plain version (max err {err})")
        return err

    def timed(self, label, kernel, plain, library, nbytes, flops, dtype,
              per_forward: int, main: bool):
        ms, pms = time_ms(kernel), time_ms(plain)
        lms = time_ms(library) if library is not None else None
        t_bytes, t_ops = bound_ms(nbytes, flops, dtype)
        b, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")
        print(f"  {self.name} {label}: kernel {ms:.4f} ms, plain {pms:.4f} "
              f"ms, library {'%.4f ms' % lms if lms is not None else 'n/a'},"
              f" bound {b:.4f} ms ({by}); {per_forward} launch(es) per "
              f"semseg forward")
        if main:
            self.ms += per_forward * ms
            self.plain_ms += per_forward * pms
            self.bound += per_forward * b
            if lms is not None:
                self.library_ms = (self.library_ms or 0.0) + per_forward * lms
            self.bytes_ms += per_forward * t_bytes
            self.ops_ms += per_forward * t_ops

    def record(self, launches: int) -> dict:
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": REPLACES[self.name], "launches": launches,
                "max_abs_err": self.max_err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound,
                "bound_by": ("bytes" if self.bytes_ms >= self.ops_ms
                             else "operations"),
                "library_ms": self.library_ms,
                "per": f"one semseg forward at B={BATCH} (bf16)"}


# ------------------------------------------------------------ phase 2


def check_unified_linear() -> KernelCheck:
    from repro_torch.kernels import unified_linear as kul

    kc = KernelCheck("unified_linear", "src/repro_torch/csrc/unified_linear.cu")
    # (label, K, N, bias, activation, use_lut, launches per semseg forward)
    shapes = [("patch_embed", 768, 192, True, None, False, 1),
              ("qkvo", 192, 192, False, None, False, 48),
              ("mlp_up_gelu_lut", 192, 768, True, "gelu", True, 6),
              ("mlp_down", 768, 192, True, None, False, 6),
              ("semseg_head", 192, 4864, True, None, False, 1),
              ("depth_head", 192, 256, True, None, False, 0)]
    for dtype in (torch.bfloat16, torch.float32):
        for i, (label, k, n, has_b, act, lut, per) in enumerate(shapes):
            x = randn((TOKENS, k), dtype, seed=10 + i)
            w = randn((k, n), dtype, 1.0 / math.sqrt(k), seed=20 + i)
            b = randn((n,), torch.float32, 0.1, seed=30 + i) if has_b else None
            got = kul.unified_linear(x, w, b, activation=act, use_lut=lut)
            want = kul.unified_linear_plain(x, w, b, activation=act,
                                            use_lut=lut)
            pre = kul.unified_linear_plain(x, w, b) if lut else None
            tag = f"{label} M={TOKENS} K={k} N={n} {str(dtype)[6:]}"
            err = kc.check(tag, got, want, dtype, lut_pre=pre)
            s = x.element_size()
            nbytes = (TOKENS * k + k * n + TOKENS * n) * s \
                + (4 * n if has_b else 0) + (8192 if lut else 0)
            kc.timed(tag,
                     lambda: kul.unified_linear(x, w, b, activation=act,
                                                use_lut=lut),
                     lambda: kul.unified_linear_plain(x, w, b,
                                                      activation=act,
                                                      use_lut=lut),
                     lambda: torch.matmul(x, w), nbytes,
                     2.0 * TOKENS * n * k, dtype, per,
                     main=dtype == torch.bfloat16)
            if dtype == torch.bfloat16:
                kc.max_err = max(kc.max_err, err)
    # ragged: odd M, K, N; SiLU through the LUT epilogue; float32
    x = randn((1000, 190), torch.float32, seed=40)
    w = randn((190, 770), torch.float32, 0.07, seed=41)
    b = randn((770,), torch.float32, 0.1, seed=42)
    got = kul.unified_linear(x, w, b, activation="silu", use_lut=True)
    want = kul.unified_linear_plain(x, w, b, activation="silu", use_lut=True)
    kc.check("ragged M=1000 K=190 N=770 silu-lut float32", got, want,
             torch.float32, lut_pre=kul.unified_linear_plain(x, w, b),
             kind="silu")
    x16 = randn((77, 33), torch.bfloat16, seed=43)
    w16 = randn((33, 129), torch.bfloat16, 0.2, seed=44)
    kc.check("ragged M=77 K=33 N=129 erf-gelu bf16",
             kul.unified_linear(x16, w16, b[:129], activation="gelu"),
             kul.unified_linear_plain(x16, w16, b[:129], activation="gelu"),
             torch.bfloat16)
    return kc


def check_flash_attention() -> KernelCheck:
    from repro_torch.kernels import flash_attention as kfa

    kc = KernelCheck("flash_attention",
                     "src/repro_torch/csrc/flash_attention.cu")
    shape = (BATCH, 3, 128, 64)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (randn(shape, dtype, seed=s) for s in (1, 2, 3))
        tag = f"main B={BATCH} H=3 S=128 D=64 non-causal {str(dtype)[6:]}"
        err = kc.check(tag, kfa.flash_attention(q, k, v, causal=False),
                       kfa.flash_attention_plain(q, k, v, causal=False),
                       dtype)
        b_, h, s, d = shape
        kc.timed(tag,
                 lambda: kfa.flash_attention(q, k, v, causal=False),
                 lambda: kfa.flash_attention_plain(q, k, v, causal=False),
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     q, k, v, scale=1.0 / math.sqrt(d)),
                 4 * b_ * h * s * d * q.element_size(),
                 4.0 * b_ * h * s * s * d, dtype, 12,
                 main=dtype == torch.bfloat16)
        if dtype == torch.bfloat16:
            kc.max_err = max(kc.max_err, err)
    # ragged: GQA 6/2, Sq 77 vs Skv 100, head_dim 48, causal + window +
    # q_offset
    q = randn((2, 6, 77, 48), torch.bfloat16, seed=4)
    k = randn((2, 2, 100, 48), torch.bfloat16, seed=5)
    v = randn((2, 2, 100, 48), torch.bfloat16, seed=6)
    kw = dict(causal=True, window=24, q_offset=23)
    kc.check("ragged GQA 6/2 Sq=77 Skv=100 D=48 causal window=24 "
             "q_offset=23 bf16", kfa.flash_attention(q, k, v, **kw),
             kfa.flash_attention_plain(q, k, v, **kw), torch.bfloat16)
    return kc


def check_gelu_lut() -> KernelCheck:
    from repro_torch.kernels import gelu_lut as kgl

    kc = KernelCheck("gelu_lut", "src/repro_torch/csrc/gelu_lut.cu")
    shape = (BATCH, 16, 68, 768)     # MoE hidden after + b1, float32
    for dtype in (torch.float32, torch.bfloat16):
        x = randn(shape, dtype, 3.0, seed=7)
        tag = f"main G={BATCH} E=16 C=68 F=768 {str(dtype)[6:]} (bit-exact)"
        got, want = kgl.lut_activation(x), kgl.lut_activation_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gelu_lut {tag}: not bit-exact")
        print(f"  gelu_lut {tag}: max_abs_err 0.000e+00 tolerance "
              "bit-exact: ok")
        n = x.numel()
        kc.timed(tag, lambda: kgl.lut_activation(x),
                 lambda: kgl.lut_activation_plain(x), None,
                 2 * n * x.element_size() + 8192, 10.0 * n, torch.float32,
                 6, main=dtype == torch.float32)
    # ragged: odd length with ±inf, NaN, values past the table, exact
    # index half-steps (half-to-even rounding)
    x = randn((1_000_003,), torch.float32, 4.0, seed=8)
    special = torch.tensor(
        [math.inf, -math.inf, math.nan, 0.0, -0.0, 8.0, -8.0, 9.5, 1e30,
         -1e30] + [(i + 0.5) / 256 for i in range(64)], device="cuda")
    x[:special.numel()] = special
    got, want = kgl.lut_activation(x, "silu"), kgl.lut_activation_plain(
        x, "silu")
    torch.cuda.synchronize()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not bool(same.all()):
        raise AssertionError("gelu_lut ragged: not bit-exact")
    print("  gelu_lut ragged n=1000003 silu float32 with inf/nan/past-table/"
          "half-steps: max_abs_err 0.000e+00 tolerance bit-exact: ok")
    return kc


def check_moe_gemm() -> KernelCheck:
    from repro_torch.core import routing as R
    from repro_torch.kernels import moe_gemm as kmg

    kc = KernelCheck("moe_gemm", "src/repro_torch/csrc/moe_gemm.cu")
    # queue lengths from real top-4 routing of 8 groups x 128 tokens
    logits = randn((BATCH, 128, 16), torch.float32, seed=9)
    sizes = R.dispatch_counts(R.route(logits, 4, 68), 16)
    live = int(sizes.sum())
    active = int((sizes > 0).any(dim=0).sum())
    print(f"  moe_gemm queues: {live} of {BATCH * 16 * 68} slots live, "
          f"{active} of 16 experts used")
    for dtype in (torch.bfloat16, torch.float32):
        for label, d, f in (("w1", 192, 768), ("w2", 768, 192)):
            buf = randn((BATCH, 16, 68, d), dtype, seed=11)
            w = randn((16, d, f), dtype, 1.0 / math.sqrt(d), seed=12)
            tag = f"main {label} G={BATCH} E=16 C=68 D={d} F={f} " \
                  f"{str(dtype)[6:]}"
            got = kmg.moe_gemm(buf, w, sizes)
            err = kc.check(tag, got, kmg.moe_gemm_plain(buf, w, sizes),
                           dtype)
            keep = torch.arange(68, device="cuda")[None, None, :, None] \
                < sizes[:, :, None, None]
            if bool((got.masked_select(~keep) != 0).any()):
                raise AssertionError("moe_gemm: rows past a queue not zero")
            xb = buf.transpose(0, 1).reshape(16, BATCH * 68, d).contiguous()
            s = buf.element_size()
            nbytes = live * d * s + active * d * f * s \
                + BATCH * 16 * 68 * f * s + 4 * BATCH * 16
            kc.timed(tag, lambda: kmg.moe_gemm(buf, w, sizes),
                     lambda: kmg.moe_gemm_plain(buf, w, sizes),
                     lambda: torch.bmm(xb, w), nbytes, 2.0 * live * d * f,
                     dtype, 6, main=dtype == torch.bfloat16)
            if dtype == torch.bfloat16:
                kc.max_err = max(kc.max_err, err)
    # ragged: 3 groups x 5 experts, C=13, D=37, F=29, empty and partial
    # queues, garbage in the queue tails
    buf = randn((3, 5, 13, 37), torch.float32, seed=13)
    w = randn((5, 37, 29), torch.float32, 0.2, seed=14)
    rs = torch.tensor([[0, 13, 7, 0, 1], [5, 0, 0, 13, 2], [0, 0, 0, 0, 0]],
                      dtype=torch.int32, device="cuda")
    got = kmg.moe_gemm(buf, w, rs)
    kc.check("ragged G=3 E=5 C=13 D=37 F=29 float32", got,
             kmg.moe_gemm_plain(buf, w, rs), torch.float32)
    keep = torch.arange(13, device="cuda")[None, None, :, None] \
        < rs[:, :, None, None]
    if bool((got.masked_select(~keep) != 0).any()):
        raise AssertionError("moe_gemm ragged: rows past a queue not zero")
    return kc


# ------------------------------------------------------------ phase 3


def main_path():
    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.compare import cosine
    from repro_torch.models.vit import init_params
    from repro_torch.serve.profile import wall_per_batch
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
    torch.cuda.synchronize()

    reset_launch_counts()
    ops.reset_dispatch_report()
    outs = {task: server.infer(imgs, task)      # returns on the host
            for task, imgs in batches}
    counts = launch_counts()
    report = ops.dispatch_report()

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
    if not all(n > 0 for n in counts.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{counts}")
    for op in ("linear", "attention", "moe_grouped_gemm", "activation"):
        entry = report.get(op, {})
        if entry.get("fallbacks") or entry.get("modes", {}).get("cuda") \
                != {"cuda": entry.get("hits", {}).get("cuda", -1)}:
            raise AssertionError(f"dispatch report for {op}: {entry}")
    print(f"  dispatch report: {json.dumps(report)}")
    for task, imgs in batches:
        wall = statistics.median(wall_per_batch(server, imgs, task, reps=5,
                                                warmup=0))
        print(f"  {task}: {wall * 1e3:.3f} ms per batch of {BATCH} (median "
              f"of 5, host wall to the result on the host), "
              f"{BATCH / wall:.1f} img/s")
    return counts


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
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("   " + line.strip())

    print("phase 2: kernels against their plain versions")
    checks = [check_unified_linear(), check_flash_attention(),
              check_gelu_lut(), check_moe_gemm()]

    print("phase 3: main path")
    counts = main_path()

    print(smi)
    print(json.dumps({"kernels": [kc.record(counts[kc.name])
                                  for kc in checks]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
