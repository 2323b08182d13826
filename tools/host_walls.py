#!/usr/bin/env python3
"""Host walls of the unmeshed serving paths, for comparing two trees of
the port on one card: Llama-3.2-1B ``ServingEngine.generate`` (8 × 128
prompts, 32 greedy tokens, ``cuda`` with ``attention_decode=
"cuda_fused"``, weights drawn on the card) and full-width M³ViT
``M3ViTServer.infer`` (batch 8, semseg, ``cuda``), all experts resident
and paged at resident fraction 0.5.  No mesh, no rules: what every
unmeshed caller pays.

    python3 tools/host_walls.py [--src SRC] [--label NAME] [--reps 7]

``--src`` is the ``src`` directory of the tree to import (default: this
tree's); each tree builds its own kernels under its root's ``build/``.
Run the trees alternately in one machine (parent, change, change,
parent) and compare within that call.  Prints the card's name and power
limit, then one JSON line: each path's walls in ms (every repetition and
their median, after one warm-up call).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _walls(run, reps: int) -> dict:
    import torch

    run()                                           # warm-up
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(walls), "ms": walls}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("host_walls: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    from dataclasses import replace

    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.configs import m3vit as MV
    from repro_torch.kernels import build
    from repro_torch.models import model as LM
    from repro_torch.models import vit as V
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.serve.vision import M3ViTServer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    build.build_seconds()
    out = {"label": args.label or args.src, "card": smi.splitlines()[0]}

    policy = ops.policy_named("cuda").with_impls(
        attention_decode="cuda_fused")
    cfg = LL.CONFIG
    params = LM.init_params(0, cfg, draw_on_device=True)
    engine = ServingEngine(cfg, params, ServeConfig(max_len=512,
                                                    policy=policy))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(8, 128))).cuda()
    out["llama3_2_1b_generate_8x128_32"] = _walls(
        lambda: engine.generate(prompts, 32), args.reps)
    del engine, params
    torch.cuda.empty_cache()

    vcfg = replace(MV.CONFIG, policy=ops.policy_named("cuda"))
    vparams = V.init_params(0, vcfg)
    imgs = np.random.default_rng(0).normal(
        size=(8, MV.IMAGE_H, MV.IMAGE_W, 3)).astype(np.float32)
    for name, frac in (("m3vit_infer_b8_resident", 1.0),
                       ("m3vit_infer_b8_paged_0.5", 0.5)):
        server = M3ViTServer(vcfg, vparams, resident_fraction=frac)
        out[name] = _walls(lambda: server.infer(imgs, "semseg"), args.reps)
        del server
    print(json.dumps(out))


if __name__ == "__main__":
    main()
