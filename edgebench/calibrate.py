"""Readings that a cell's check limits are set from, in one process.

    python3 edgebench/calibrate.py --workload <cell> --seeds 11,12,...
        [--control 3] [--seconds 8] [--out chiprun_out/calib.jsonl]

For every seed: one run of the cell (a shorter window, the cell's own
load and sizes) and the numbers its check compares.  For the first
``--control`` seeds also the control's: the plain reference computed with
every matrix product in float8 e4m3 in the program's place, on the same
answers' inputs (vision: the sampled frames; decoders: the sampled
prompts and served tokens, reading at each position the gap of the token
the control puts first).  The limit lies between the largest program
reading and the smallest control reading; ``PERF.md`` gives both.  Not
part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run as RUN  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    RUN.setup_paths()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        line, out = RUN.measure(args.workload, seed, args.seconds, False,
                                "cuda", t, control=i < args.control)
        rec = {"cell": args.workload, "seed": seed,
               "program": {k: v for k, (v, _) in out["checks"].items()},
               "errors": out.get("errors"),
               "control_errors": out.get("control_errors"),
               "control": out.get("control"),
               "sampled": out["sampled"], "failed": out["failed"],
               "metrics": {k: v["value"] for k, v in line["metrics"].items()},
               "seconds": time.perf_counter() - t}
        print(json.dumps(rec), flush=True)
        if sink:
            sink.write(json.dumps(rec) + "\n")
            sink.flush()
        del line, out
        gc.collect()
        torch.cuda.empty_cache()
    bad = RUN.banned_modules()
    if bad:
        print(f"calibrate: loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
