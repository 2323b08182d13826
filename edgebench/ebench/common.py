"""What every driver shares: the run's context, the closed-loop window's
bookkeeping and the seeded sample of answers kept for the check."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import numpy as np
import torch

#: seconds a run waits past the window's close for answers still due
DRAIN_S = 60.0


@dataclass
class Context:
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                  # perf_counter at the process's start
    reference: object = None        # the configuration's plain reference
    control: bool = False           # also read the control (calibration)

    def elapsed(self) -> float:
        """Seconds since the process started."""
        return time.perf_counter() - self.t_start


def process_age() -> float:
    """Seconds since this process started (Linux; 0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        import os

        return max(0.0, up - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Reservoir:
    """A seeded uniform sample of ``k`` items from a stream."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: list = []
        self.seen = 0
        self.rng = np.random.default_rng([seed % 2**63, 7])

    def offer(self, make):
        """Count one item; keep ``make()`` if the sample takes it."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = make()


def settle(tracer, trace: bool) -> None:
    """The end of a run's set-up: the profiler primed for a traced run,
    the set-up's objects collected and frozen out of the collector's
    later passes."""
    if trace:
        tracer.prime()
    gc.collect()
    gc.freeze()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def now() -> float:
    return time.perf_counter()
