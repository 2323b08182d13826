"""Where the time of one M³ViT batch, or of one Llama-3.2-1B decode step,
goes on the card.

    python -m repro_torch.serve.profile [--batch 8] [--reps 5] [--paged]
                                        [--lm]

Serves ``--reps`` batches of ``--batch`` semseg images through an
``M3ViTServer`` at the full ``CONFIG`` (bf16, seeded random weights) under
the ``cuda`` policy (the kernels), under ``cuda`` with
``moe_ffn="cuda_fused"`` (the fused MoE kernel), under ``cuda`` with half
of each MoE layer's experts resident, paged synchronously and through the
copy-stream ``TransferEngine`` (with ``--paged``; with the paged layers'
cache counters per batch), and under the plain ``blocked`` policy, and prints
for each: the host wall time per batch
(median, from :func:`wall_per_batch`, the timer ``chip_smoke.py`` uses
too), then from a second run of the same batches under ``torch.profiler``
the device's busy time per batch (the union of all kernel and copy
intervals), its idle share of the unprofiled wall time, and the device
time by kernel name.  The profiled run's own span is printed but not used:
the profiler's host overhead stretches it.  With ``--lm`` it does the same
for decode steps of a ``ServingEngine`` at the full Llama-3.2-1B
``CONFIG`` (bf16, seeded random weights, ``--batch`` prompts of 128
tokens, ``max_len`` 512) under ``cuda`` with
``attention_decode="cuda_fused"``: ``--reps`` timed steps, then ``--reps``
profiled ones.  The first line is the card's name and power limit
(``nvidia-smi``).  It needs a card and refuses to run without one.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from collections import defaultdict
from dataclasses import replace

import numpy as np
import torch

from repro_torch import ops
from repro_torch.configs import m3vit as MV
from repro_torch.models.vit import init_params
from repro_torch.serve.vision import M3ViTServer


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _short(name: str) -> str:
    name = name.split("(")[0].removeprefix("void ")
    return name if len(name) <= 70 else name[:67] + "..."


def wall_per_batch(server, images, task, reps: int,
                   warmup: int = 3) -> list[float]:
    """Host wall seconds of each of ``reps`` calls of ``server.infer``
    after ``warmup`` untimed ones, each from an idle card to the result on
    the host."""
    for _ in range(warmup):
        server.infer(images, task)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.infer(images, task)
        walls.append(time.perf_counter() - t0)
    return walls


def _report(label: str, unit: str, run, reps: int, wall: float) -> None:
    """Run ``run()`` ``reps`` times under ``torch.profiler`` and print the
    device's busy time per ``unit``, its idle share of the unprofiled
    ``wall`` (seconds per unit) and the device time by kernel name."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        span_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in device)
    by_name = defaultdict(float)
    counts = defaultdict(int)
    for e in device:
        by_name[_short(e.name)] += e.time_range.elapsed_us()
        counts[_short(e.name)] += 1
    busy_ms = busy / reps / 1e3
    print(f"{label}: wall {wall * 1e3:.3f} ms per {unit} (median of {reps})")
    print(f"  device busy {busy_ms:.3f} ms per {unit}, idle share "
          f"{1 - busy_ms / (wall * 1e3):.3f} of the wall; {len(device)} "
          f"device events in {reps} {unit}s (profiled span "
          f"{span_us / 1e3:.3f} ms, stretched by the profiler)")
    if not device:
        raise RuntimeError("the profiler recorded no device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {us / reps / 1e3:9.4f} ms/{unit}  {us / busy:6.1%} of "
              f"busy  x{counts[name] // reps:<4d} {name}")


# name -> (compute policy, M3ViTServer arguments)
M3VIT_RUNS = {
    "cuda": (ops.policy_named("cuda"), {}),
    "cuda+moe_ffn=cuda_fused": (ops.policy_named("cuda").with_impls(
        moe_ffn="cuda_fused"), {}),
    "cuda, paged 0.5 sync": (ops.policy_named("cuda"),
                             {"resident_fraction": 0.5}),
    "cuda, paged 0.5 async": (ops.policy_named("cuda"),
                              {"resident_fraction": 0.5,
                               "async_paging": True}),
    "blocked": (ops.policy_named("blocked"), {}),
}
PAGED_RUNS = ("cuda, paged 0.5 sync", "cuda, paged 0.5 async")


def profile_policy(name: str, params, images, reps: int) -> None:
    policy, kwargs = M3VIT_RUNS[name]
    server = M3ViTServer(replace(MV.CONFIG, policy=policy), params,
                         **kwargs)
    wall = statistics.median(wall_per_batch(server, images, "semseg", reps))
    n = images.shape[0]
    server.reset_stats()
    _report(f"policy {name}, {n / wall:.1f} img/s at batch {n}", "batch",
            lambda: server.infer(images, "semseg"), reps, wall)
    if server.paged:
        s = server.cache_stats()
        print(f"  paged layers over the {reps} profiled batches: hit rate "
              f"{s['hit_rate']:.4f}, {s['bytes_paged'] / reps:.0f} bytes "
              f"paged per batch"
              + (f", copy stall {s['stall_s'] * 1e3 / reps:.3f} ms and "
                 f"hidden {s['hidden_s'] * 1e3 / reps:.3f} ms per batch, "
                 f"overlap ratio {s['overlap_ratio']:.4f}"
                 if server.engine is not None else ""))


def profile_lm(batch: int, reps: int) -> None:
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg, prompt_len, max_len = LL.CONFIG, 128, 512
    policy = ops.policy_named("cuda").with_impls(
        attention_decode="cuda_fused")
    engine = ServingEngine(cfg, LM.init_params(0, cfg),
                           ServeConfig(max_len=max_len, policy=policy))
    prefill, decode = engine.steps()
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(batch, prompt_len))).to(engine.device)
    with torch.inference_mode():
        logits, state = prefill(engine.params, prompts,
                                LM.init_state(cfg, batch, max_len))
        step = {"i": 0, "logits": logits, "state": state}

        def one():
            tok = torch.argmax(step["logits"], -1)[:, None]
            step["logits"], step["state"] = decode(
                engine.params, tok, step["state"], prompt_len + step["i"])
            step["i"] += 1

        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        _report(f"Llama-3.2-1B decode at batch {batch}, {batch / wall:.1f} "
                f"tokens/s", "step", one, reps, wall)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--lm", action="store_true",
                    help="profile Llama-3.2-1B decode steps instead")
    ap.add_argument("--paged", action="store_true",
                    help="add the paged runs (half the experts resident, "
                    "synchronous and asynchronous)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: CUDA is not available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.lm:
        profile_lm(args.batch, args.reps)
        return
    params = init_params(0, MV.CONFIG)
    images = np.random.default_rng(0).normal(
        size=(args.batch, MV.IMAGE_H, MV.IMAGE_W, 3)).astype(np.float32)
    for name in M3VIT_RUNS:
        if args.paged or name not in PAGED_RUNS:
            profile_policy(name, params, images, args.reps)


if __name__ == "__main__":
    main()
