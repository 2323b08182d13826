"""Where the time of one M³ViT batch goes on the card.

    python -m repro_torch.serve.profile [--batch 8] [--reps 5]

Serves ``--reps`` batches of ``--batch`` semseg images through an
``M3ViTServer`` at the full ``CONFIG`` (bf16, seeded random weights), once
under the ``cuda`` policy (the kernels) and once under the plain
``blocked`` policy, and prints for each: the host wall time per batch
(median, from :func:`wall_per_batch`, the timer ``chip_smoke.py`` uses
too), then from a second run of the same batches under ``torch.profiler``
the device's busy time per batch (the union of all kernel and copy
intervals), its idle share of the unprofiled wall time, and the device
time by kernel name.  The profiled run's own span is printed but not used:
the profiler's host overhead stretches it.  It needs a card and refuses to
run without one.
"""

from __future__ import annotations

import argparse
import statistics
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


def profile_policy(policy: str, params, images, reps: int) -> None:
    cfg = replace(MV.CONFIG, policy=ops.policy_named(policy))
    server = M3ViTServer(cfg, params)
    wall = statistics.median(wall_per_batch(server, images, "semseg", reps))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            server.infer(images, "semseg")
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
    n = images.shape[0]
    busy_ms = busy / reps / 1e3
    print(f"policy {policy}: wall {wall * 1e3:.3f} ms per batch of {n} "
          f"(median of {reps}), {n / wall:.1f} img/s")
    print(f"  device busy {busy_ms:.3f} ms per batch, idle share "
          f"{1 - busy_ms / (wall * 1e3):.3f} of the wall; {len(device)} "
          f"device events in {reps} batches (profiled span {span_us / 1e3:.3f}"
          f" ms, stretched by the profiler)")
    if not device:
        raise RuntimeError("the profiler recorded no device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {us / reps / 1e3:9.4f} ms/batch  {us / busy:6.1%} of busy"
              f"  x{counts[name] // reps:<4d} {name}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: CUDA is not available")
    params = init_params(0, MV.CONFIG)
    images = np.random.default_rng(0).normal(
        size=(args.batch, MV.IMAGE_H, MV.IMAGE_W, 3)).astype(np.float32)
    for policy in ("cuda", "blocked"):
        profile_policy(policy, params, images, args.reps)


if __name__ == "__main__":
    main()
