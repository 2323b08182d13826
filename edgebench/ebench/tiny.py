"""A checkout of the benchmark at tiny sizes, for the CPU tests: the
manifest's configurations' widths and depths and every traffic mix cut
down, written under a scratch root beside copies of the references and
the metric readers.  The check limits at these sizes lie between the
program's readings on the CPU (M³ViT ≤ 0.018, the decoder ≤ 0.030 over
seeds 11-18) and the float8 control's (≥ 0.081, ≥ 0.112)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from ebench import manifest as M

TINY_CONFIGS = {
    "m3vit": dict(num_layers=2, d_model=64, num_heads=2, d_ff=128,
                  num_experts=4, top_k=2, expert_d_ff=64,
                  check={"rel_err_mean": 0.05}),
    "deepseek_67b": dict(hidden_size=64, intermediate_size=128,
                         num_attention_heads=4, num_key_value_heads=2,
                         num_hidden_layers=2, vocab_size=256,
                         check={"logit_gap_max": 0.07}),
}

TINY_TRAFFIC = {
    "pairs-c256": {"loop": "closed", "clients": 4, "image_pool": 4,
                   "scheduler": {"total_slots": 4, "quantum": 1},
                   "sample_frames": 4, "trace_s": 0.2},
    "cameras-open": {"loop": "open", "cameras": 4, "image_pool": 4,
                     "rate_per_s": 40.0,
                     "burst": {"period_s": 0.5, "on_s": 0.25,
                               "on_factor": 1.5, "off_factor": 0.5},
                     "preroll_s": 0.5,
                     "scheduler": {"total_slots": 4, "quantum": 1},
                     "sample_frames": 4, "trace_s": 0.2},
    "chat-c32": {"loop": "closed", "clients": 4,
                 "prompt": {"median": 24, "sigma": 0.8, "min": 8,
                            "max": 64},
                 "output": {"median": 8, "sigma": 0.8, "min": 2, "max": 32},
                 "scheduler": {"total_slots": 4, "quantum": 1},
                 "check_requests": 64, "check_tokens": 32, "trace_s": 0.2},
    "rag-c32": {"loop": "closed", "clients": 4,
                "prompt": {"median": 96, "sigma": 0.5, "min": 48,
                           "max": 160},
                "output": {"median": 4, "sigma": 0.8, "min": 2, "max": 8},
                "scheduler": {"total_slots": 4, "quantum": 1},
                "check_requests": 64, "check_tokens": 32, "trace_s": 0.2},
}


def write_root(root: Path, manifest: dict | None = None) -> dict:
    """The manifest's cells at tiny sizes under ``root``; returns the
    manifest loaded from there."""
    root = Path(root)
    m = dict(manifest or M.load())
    m.pop("_root", None)
    bench = root / "edgebench"
    for d in ("reference", "metrics"):
        shutil.copytree(M.ROOT / "edgebench" / d, bench / d,
                        dirs_exist_ok=True)
    for d in ("configs", "traffic"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    for c in m["configs"]:
        cfg = json.loads((M.ROOT / c["file"]).read_text())
        cfg.update(TINY_CONFIGS.get(c["name"], {}))
        if "serve" in cfg and "max_len" in cfg["serve"]:
            cfg["serve"] = dict(cfg["serve"], max_len=256)
        (root / c["file"]).write_text(json.dumps(cfg))
    for name, mix in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return M.load(root)
