"""The highest rate an open-loop cell sustains, found by a sweep in one
process, and the cell's rate set from it.

    python3 edgebench/sweep.py --workload <cell> --rates 800,1000,...
        [--seconds 10] [--share 0.8] [--write]

Runs the cell once at each mean rate (the traffic file's bursts kept) and
prints, per rate, the frames due and completed in the window, the backlog
left at its close and the 95th percentile latency.  A rate is sustained
when the window completes at least 98 % of its due frames, leaves no more
than two buckets' frames behind and keeps the tail under a second.  The
knee is the highest rate sustained with every lower one (the rates run
upward and the sweep stops at the first that fails); ``--write`` sets
the traffic file's ``rate_per_s`` to ``--share`` of it.  Not part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run as RUN  # noqa: E402


def sustained(rec: dict, slots: int) -> bool:
    return (rec["done"] >= 0.98 * rec["due"]
            and rec["backlog"] <= 2 * slots and rec["p95_ms"] < 1000.0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--share", type=float, default=0.8)
    p.add_argument("--write", action="store_true")
    args = p.parse_args(argv)
    RUN.setup_paths()
    import torch

    from ebench import manifest as M

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    m = M.load()
    entry = M.cell(m, args.workload)
    tr = M.traffic(m, entry)
    slots = tr["scheduler"]["total_slots"]
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        line, out = RUN.measure(args.workload, args.seed, args.seconds,
                                False, "cuda", time.perf_counter(),
                                manifest=m, traffic={"rate_per_s": rate})
        c = out["counters"]
        rec = {"rate_per_s": rate, "due": c["due"],
               "done": out["e2e"]["frames_per_s"] * c["window_s"],
               "backlog": c["backlog_at_close"],
               "p95_ms": out["e2e"]["frame_p95_ms"],
               "correct": line["correct"]}
        rec["sustained"] = sustained(rec, slots)
        print(json.dumps(rec), flush=True)
        if not rec["sustained"]:
            break               # the rates run upward: the knee is behind
        knee = rate
    print(json.dumps({"knee_per_s": knee}), flush=True)
    if args.write and knee is not None:
        path = M.ROOT / "edgebench" / "traffic" / f"{entry['traffic']}.json"
        tr = json.loads(path.read_text())
        tr["rate_per_s"] = round(args.share * knee, 1)
        tr["knee_per_s"] = knee
        path.write_text(json.dumps(tr, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
