"""Run one cell of the benchmark once, on the card, and print its result.

    python3 edgebench/run.py --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>

From the root of a checkout (``repro_torch`` under ``src/``).  With
``--trace 0`` the last line of standard output is the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics; both carry ``correct``,
decided by holding a seeded sample of the window's answers to the plain
reference, each number compared printed with its limit under ``check``
(last) and as the last lines of standard error.  The run refuses, with no
result, without enough cards, and when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list[str]:
    """Loaded modules of JAX or the JAX package, top-level names whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in BANNED})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def setup_paths() -> None:
    for path in (ROOT / "src", ROOT / "edgebench"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    # every build and kernel cache inside the checkout, at fixed paths
    cache = ROOT / "build" / "edgebench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def measure(cell: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, manifest=None, control=False, traffic=None):
    """Run the cell once; returns (the result line as a dict, the
    driver's outcome).  ``traffic`` replaces keys of the cell's traffic
    file (the rate sweep's rates)."""
    import torch

    from ebench import manifest as M
    from ebench.common import Context

    m = manifest or M.load()
    entry = M.cell(m, cell)
    cfg = M.config(m, entry)
    mix = dict(M.traffic(m, entry), **(traffic or {}))
    ctx = Context(cell=cell, config=cfg, traffic=mix, seed=seed,
                  seconds=seconds, trace=trace, device=torch.device(device),
                  t_start=t_start, reference=M.reference(cfg),
                  control=control)
    out = M.driver(cfg).run(ctx)
    checks = out["checks"]
    correct = out["failed"] == 0 and all(
        lim is not None and math.isfinite(v) and v <= lim
        for v, lim in checks.values())
    dev = ctx.device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if trace:
        metrics = {}
        run = Reading(cfg, out, kind)
        for spec in M.per_layer(m, cell):
            value = M.reader(m, spec["name"]).read(run)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        units = {s["name"]: s["unit"] for s in M.end_to_end(m, cell)}
        metrics = {n: {"value": out["e2e"][n], "unit": u}
                   for n, u in units.items()}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": entry["chips"],
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    tr = out["trace"]
    if trace and tr is not None:
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["check"] = {name: {"value": v if math.isfinite(v) else None,
                            "limit": lim}
                     for name, (v, lim) in checks.items()}
    line["check"]["failed"] = {"value": out["failed"], "limit": 0}
    return line, out


class Reading:
    """What a per-layer metric's reader reads: the configuration, the
    card's name, the run's counters, and the traced stretch (None without
    one)."""

    def __init__(self, config: dict, out: dict, kind: str):
        self.config = config
        self.kind = kind
        self.counters = out["counters"]
        self.trace = out["trace"]


def main(argv=None) -> int:
    args = parse(argv)
    setup_paths()
    from ebench.common import process_age

    t_start = T0 - process_age()
    marks = [("python", time.perf_counter() - t_start)]
    import torch

    # one process on the card with few host threads: the host paces these
    # cells, and idle intra-op threads only compete with the serving loop
    torch.set_num_threads(1)
    marks.append(("torch", time.perf_counter() - t_start))
    from ebench import manifest as M

    m = M.load()
    chips = M.cell(m, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"edgebench: the cell needs {chips} CUDA card(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    torch.cuda.init()
    marks.append(("cuda", time.perf_counter() - t_start))
    line, out = measure(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", t_start, manifest=m)
    bad = banned_modules()
    if bad:
        print(f"edgebench: loaded {bad}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    print("setup (s since the process started): " + ", ".join(
        f"{n} {t:.2f}" for n, t in marks + out["phases"]), file=sys.stderr)
    for name, c in line["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
