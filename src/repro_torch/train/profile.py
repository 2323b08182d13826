"""Where the device time of a training step goes, read from
``torch.profiler`` as ``serve/profile.py`` reads a serving batch.

:func:`profile_steps` runs a step function ``reps`` times under the
profiler and returns, per step: the device's busy time (the union of all
kernel and copy intervals), its idle share of an unprofiled wall time per
step the caller measured, and the device time under each of the train
step's labels (``train/step.py``): ``train_step.forward``,
``train_step.optimizer`` and ``train_step.backward`` — the last counting
every operation whose host-side start falls inside a backward window on
any thread, since the autograd engine runs the backward on a thread of its
own — and under each kernel Function's backward label
(``<kernel>.backward``, ``kernels/*.py``), beside each kernel's own
forward device time (its CUDA functions by name); over a mesh, the
device time under the collectives' labels (``spmd.all_reduce``,
``spmd.all_gather``: ``dist/spmd.py``), ``collective_ms``.  It needs a
card.
"""

from __future__ import annotations

from collections import defaultdict

import torch

from repro_torch.serve.profile import _busy_us, _short

__all__ = ["profile_steps", "KERNEL_BACKWARDS", "KERNEL_PREFIXES"]

#: kernel -> the prefix of its CUDA functions' names
KERNEL_PREFIXES = {"unified_linear": "unified_linear_",
                   "flash_attention": "flash_attention_",
                   "gelu_lut": "lut_activation_",
                   "moe_gemm": "moe_gemm_"}
KERNEL_BACKWARDS = tuple(KERNEL_PREFIXES)


#: the step's and the Functions' profiler labels; on the device timeline
#: the profiler also shows each as an annotation spanning its range,
#: which is not device work
COLLECTIVE_LABELS = ("spmd.all_reduce", "spmd.all_gather")
LABELS = ("train_step.forward", "train_step.backward",
          "train_step.optimizer") + tuple(f"{k}.backward"
                                          for k in KERNEL_PREFIXES) \
    + COLLECTIVE_LABELS


def _device_us(e) -> float:
    """Device time of a host-side event and its children, in µs."""
    t = getattr(e, "device_time_total", None)
    return float(e.cuda_time_total if t is None else t)


def profile_steps(run_step, reps: int, wall_s: float) -> dict:
    """Profile ``reps`` calls of ``run_step()`` (each one train step that
    ends on the host, e.g. by reading the loss).  ``wall_s``: the caller's
    unprofiled host wall time per step.  Times in ms per step."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_steps reads device time: it needs a card")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        for _ in range(reps):
            run_step()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in LABELS]
    if not device:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = _busy_us((e.time_range.start, e.time_range.end)
                       for e in device) / reps / 1e3
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    label_us = defaultdict(float)
    windows = []
    for e in host:
        if e.name in LABELS:
            label_us[e.name] += _device_us(e)
        if e.name == "train_step.backward":
            windows.append((e.time_range.start, e.time_range.end))
    # backward: every top-level host event starting inside a backward
    # window (the engine thread's work), the window events included
    backward_us = sum(
        _device_us(e) for e in host
        if e.cpu_parent is None and e.name != "train_step.backward"
        and any(s <= e.time_range.start <= t for s, t in windows)) \
        + label_us["train_step.backward"]
    by_name = defaultdict(float)
    for e in device:
        by_name[_short(e.name)] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms": wall_s * 1e3,
        "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall_s * 1e3),
        "forward_ms": label_us["train_step.forward"] / reps / 1e3,
        "backward_ms": backward_us / reps / 1e3,
        "optimizer_ms": label_us["train_step.optimizer"] / reps / 1e3,
        "collective_ms": sum(label_us[k] for k in COLLECTIVE_LABELS)
        / reps / 1e3,
        "kernel_forward_ms": {
            k: sum(us for name, us in by_name.items()
                   if name.startswith(prefix)) / reps / 1e3
            for k, prefix in KERNEL_PREFIXES.items()},
        "kernel_backward_ms": {
            k: label_us[f"{k}.backward"] / reps / 1e3
            for k in KERNEL_BACKWARDS},
        "device_events": len(device) / reps,
        "top": [(name, us / reps / 1e3) for name, us in top],
    }
