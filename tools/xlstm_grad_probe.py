#!/usr/bin/env python3
"""How far apart two sound runs put the gradients of the whole leaves an
xLSTM rank reads in part (``chip_smoke.XL_PARTLY_READ``: ``w_if``,
``b_if``, both ``gn_scale``, ``b_gates``), beside what a missing ``f``
gives — the readings behind phase 11 (b)'s gate on them.

Two gloo ranks on the one card, as ``chip_smoke.py`` phase 11 (b), run
xLSTM-350M at full width and ``chip_smoke.TP_XL_LAYERS`` layers over
(1, 2) on ``XL_TRAIN_BATCH`` x ``XL_PROMPT`` tokens.  For each seed (the
weights and the batch), ``chip_smoke._xl_partly_read``'s readings (the
mesh against one process in float32 and in bf16, each bf16 run's cosine
to the float32 one-process gradients); then, on rank 0, one process
against itself with the batch in two microbatches, and under the plain
``eager`` kernels' other sums (two bf16 roundings of one gradient); seed
0 a second time; and seed 0 with the weights' ``f`` left out (the fault
the gate must catch).  Each leaf's cosine; the worst per reading printed
and all of them written to ``chiprun_out/xlstm_grad_probe.json``.

    python3 tools/xlstm_grad_probe.py [--seeds 0 1 2]
"""

import argparse
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402

STORE = ROOT / "build" / "xlstm_grad_probe"
OUT = ROOT / "chiprun_out" / "xlstm_grad_probe.json"


def _cos(a: dict, b: dict) -> dict:
    from repro_torch.kernels import compare

    return {k: compare.cosine(a[k], b[k]) for k in sorted(b)}


def _rank(rank: int, seeds: list, store: str, out: str) -> None:
    import torch.distributed as dist

    from repro_torch import ops
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.models import model as LM
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank)
    rules = ShardingRules.for_mesh(spmd.init_mesh((1, 2)))
    tcfg = TrainConfig(opt=OptConfig(**C.MESH_OPT))
    cfg = C._xl_config(policy=ops.policy_named("cuda"))
    eager = replace(cfg, policy=ops.policy_named("eager"))
    res = {}
    for seed, again in [(s, False) for s in seeds] + [(seeds[0], True)]:
        params = LM.init_params(seed, cfg, draw_on_device=True)
        batch = make_stream(DataConfig(
            batch=C.XL_TRAIN_BATCH, seq_len=C.XL_PROMPT,
            vocab_size=cfg.vocab_size, seed=seed)).batch(0)
        key = f"seed {seed}" + (", again" if again else "")
        r = C._xl_partly_read(rank, cfg, tcfg, params, batch, rules)
        if rank == 0 and not again:
            one = C._partly_read_grads(cfg, tcfg, params, batch)
            r["bf16 one, two microbatches"] = _cos(C._partly_read_grads(
                cfg, replace(tcfg, accum_steps=2), params, batch), one)
            r["bf16 one, eager"] = _cos(
                C._partly_read_grads(eager, tcfg, params, batch), one)
        if seed == seeds[0] and not again:
            # the fault: the weights' f left out, each rank's gradient its
            # own heads' part alone
            model_input = spmd.model_input
            spmd.model_input = lambda t, where: t if where.endswith(
                "whole leaves") else model_input(t, where)
            try:
                fault = C._xl_partly_read(rank, cfg, tcfg, params, batch,
                                          rules)
            finally:
                spmd.model_input = model_input
            r["fault: f32"], r["fault: bf16"] = fault["f32"], fault["bf16"]
            r["fault caught"] = not fault["ok"]
        res[key] = r
        del params
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        Path(out).write_text(json.dumps(res, indent=1))


def main() -> None:
    import shutil

    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("xlstm_grad_probe: runs on an NVIDIA Hopper card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch.kernels import build

    print(f"kernels built and loaded in {build.build_seconds():.1f} s")
    shutil.rmtree(STORE, ignore_errors=True)
    STORE.mkdir(parents=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.unlink(missing_ok=True)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    mp.start_processes(_rank, args=(args.seeds, str(STORE / "store"),
                                    str(OUT)), nprocs=2,
                       start_method="spawn")
    shutil.rmtree(STORE, ignore_errors=True)
    res = json.loads(OUT.read_text())
    for key, r in res.items():
        print(f"{key}:")
        for name, v in r.items():
            if isinstance(v, dict):
                k = min(v, key=v.get)
                print(f"  {name}: worst cosine {v[k]:.6f} ({k}), "
                      f"median {sorted(v.values())[len(v) // 2]:.6f}")
            else:
                print(f"  {name}: {v}")


if __name__ == "__main__":
    main()
