"""Render the dry-run and roofline tables from the dry-run's JSONs, the
port of ``repro.roofline.report``.

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        [--dir results/dryrun_torch]

Every number comes from ``launch/dryrun.py`` on the ``meta`` device:
counts from shapes, not measurements on a card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["ARCH_ORDER", "SHAPE_ORDER", "load", "fmt_bytes", "fmt_s",
           "dryrun_table", "roofline_table", "scope_summary", "main"]

ARCH_ORDER = ["musicgen_large", "llama3_2_1b", "qwen1_5_4b", "deepseek_67b",
              "phi4_mini_3_8b", "qwen2_vl_72b", "xlstm_350m",
              "recurrentgemma_9b", "llama4_scout_17b_a16e", "kimi_k2_1t_a32b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dirname: str) -> list[dict]:
    recs = []
    for fn in glob.glob(os.path.join(dirname, "*.json")):
        with open(fn) as f:
            recs.append(json.load(f))
    recs.sort(key=lambda r: (ARCH_ORDER.index(r["arch"])
                             if r["arch"] in ARCH_ORDER else 99,
                             SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in SHAPE_ORDER else 99,
                             r["mesh"], r.get("variant", "")))
    return recs


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(t: float) -> str:
    if t < 1e-3:
        return f"{t*1e6:.0f}µs"
    if t < 1.0:
        return f"{t*1e3:.1f}ms"
    return f"{t:.2f}s"


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | policy | count | FLOPs | bytes | arg bytes "
        "| peak live | out bytes | fits |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['policy']} "
            f"| {r['run_s']:.1f}s | {r['hlo_flops']:.3e} "
            f"| {fmt_bytes(r['hlo_bytes'])} "
            f"| {fmt_bytes(r['argument_bytes'])} "
            f"| {fmt_bytes(r['temp_bytes'])} "
            f"| {fmt_bytes(r['output_bytes'])} "
            f"| {'yes' if r['fits'] else 'no'} |")
    return "\n".join(lines)


def roofline_table(recs: list[dict], mesh: str = "1xH100") -> str:
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck "
        "| MODEL_FLOPS | useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {fmt_s(r['t_compute'])} | {fmt_s(r['t_memory'])} "
            f"| {fmt_s(r['t_collective'])} | **{r['bottleneck']}** "
            f"| {r['model_flops_total']:.2e} | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def collective_table(recs: list[dict]) -> str:
    """Each mesh cell's collective bytes a rank receives, by kind."""
    lines = ["| arch | shape | mesh | variant | collective bytes | by kind |",
             "|---|---|---|---|---|---|"]
    for r in recs:
        kinds = r.get("collectives") or {}
        if not kinds:
            continue
        by_kind = ", ".join(f"{k} ×{v['count']:.0f} {fmt_bytes(v['bytes'])}"
                            for k, v in sorted(kinds.items()))
        lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                     f"| {r.get('variant', '')} "
                     f"| {fmt_bytes(r['collective_bytes'])} | {by_kind} |")
    return "\n".join(lines)


def scope_summary(rec: dict, top: int = 5) -> str:
    rows = sorted(rec.get("by_scope", {}).items(),
                  key=lambda kv: -kv[1]["bytes"])[:top]
    parts = [f"{k}:{fmt_bytes(v['bytes'])}" for k, v in rows]
    return ", ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default=None,
                    help="the mesh whose roofline to print (default: "
                         "every mesh in the records)")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print(f"## Dry-run ({len(recs)} cells, meta device, not measured)\n")
    print(dryrun_table(recs))
    meshes = [args.mesh] if args.mesh else sorted({r["mesh"] for r in recs})
    for mesh in meshes:
        print(f"\n## Roofline ({mesh}, per rank)\n")
        print(roofline_table(recs, mesh))
    if any(r.get("collectives") for r in recs):
        print("\n## Collectives (bytes a rank receives)\n")
        print(collective_table(recs))
    print("\n## Bytes by scope (top 5)\n")
    for r in recs:
        print(f"- {r['arch']} × {r['shape']}: {scope_summary(r)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
