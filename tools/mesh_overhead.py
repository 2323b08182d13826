#!/usr/bin/env python3
"""What a mesh of one costs the Llama-3.2-1B engine's host loop on the
card: the same ``ServingEngine.generate`` (8 × 128 prompts, 32 greedy
tokens, ``cuda`` with ``attention_decode="cuda_fused"``, weights drawn on
the card) with and without ``rules`` over a (1, 1) NCCL mesh, in the
order plain, mesh, mesh, plain, repeated, then the functions whose host
time differs most between one profiled call of each (``cProfile``).

    python3 tools/mesh_overhead.py [--rounds 3]

Prints the card's name and power limit beside every wall.
"""

import argparse
import cProfile
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _wall(run) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _self_times(run) -> dict:
    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    return {f"{Path(k[0]).name}:{k[1]}({k[2]})": v[2]
            for k, v in stats.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mesh_overhead: runs on an NVIDIA card")
    import torch.distributed as dist

    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.dist.spmd import init_mesh
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    rules = ShardingRules.for_mesh(init_mesh((1, 1)), fsdp=False)
    policy = ops.policy_named("cuda").with_impls(attention_decode="cuda_fused")
    params = LM.init_params(0, LL.CONFIG, draw_on_device=True)
    scfg = ServeConfig(max_len=512, policy=policy)
    engines = {"plain": ServingEngine(LL.CONFIG, params, scfg),
               "mesh": ServingEngine(LL.CONFIG, params, scfg, rules=rules)}
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, LL.CONFIG.vocab_size, size=(8, 128))).cuda()
    for e in engines.values():
        e.generate(prompts, 2)
    walls = {"plain": [], "mesh": []}
    for _ in range(args.rounds):
        for name in ("plain", "mesh", "mesh", "plain"):
            walls[name].append(_wall(
                lambda: engines[name].generate(prompts, 32)))
    for name, w in walls.items():
        print(f"{smi}: generate {name}: median {np.median(w):.1f} ms of "
              f"{', '.join(f'{v:.1f}' for v in w)}")
    selfs = {name: _self_times(lambda: e.generate(prompts, 32))
             for name, e in engines.items()}
    diff = sorted(((selfs["mesh"].get(k, 0.0) - selfs["plain"].get(k, 0.0),
                    k) for k in set(selfs["mesh"]) | set(selfs["plain"])),
                  reverse=True)
    print(f"host self time, mesh less plain, one profiled generate each "
          f"(total {sum(selfs['mesh'].values()) * 1e3:.1f} against "
          f"{sum(selfs['plain'].values()) * 1e3:.1f} ms):")
    for d, k in diff[:12]:
        print(f"  {d * 1e3:+9.2f} ms  {k}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
