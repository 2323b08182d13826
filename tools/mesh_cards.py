#!/usr/bin/env python3
"""Mesh serving across cards, one process a card under ``torchrun`` (NCCL):
each rank runs the mesh path and the same work with no mesh on its own
card, and holds the two against each other.

    python3 -c "from repro_torch.kernels import build; build.build_seconds()"
    torchrun --standalone --nproc-per-node 4 tools/mesh_cards.py --mesh 1x4
    torchrun --standalone --nproc-per-node 4 tools/mesh_cards.py --mesh 2x2

(build once before ``torchrun``: the ranks then load the same library
instead of compiling it side by side).  ``--device cpu`` runs the same
over gloo with the kernels' plain versions, at the models' smoke sizes
(a rehearsal).  Checks, at full width, bf16, seeded:

* M³ViT ``M3ViTServer(rules=)`` paged through ``ShardedExpertCache`` at
  resident fraction 0.5, batch 8, both tasks, against the unmeshed
  all-resident server: bit for bit (expert-parallel paging is exact);
* ``apply_moe_ep_local`` on an M³ViT MoE layer (16 experts over
  ``model``) against ``grouped``: within the bf16 tolerance of
  ``kernels/compare.py``;
* Llama-3.2-1B ``ServingEngine(rules=)``, 8 × 128 prompts, 32 greedy
  tokens, against the unmeshed engine: the tokens;
* Llama-4-Scout at full width, 2 of its 48 layers, the same: its
  4096-token routing groups span the data ranks, so every rank routes
  the whole batch from the gathered router logits.

Rank 0 prints the card's name and power limit, each check's result, the
launches by kernel of each mesh run, the collectives, and the host walls
(median of 3) with and without the mesh.  Any failed check raises.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist


SCOUT_LAYERS = 2        # Llama-4-Scout's depth here, at full width


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _wall_ms(run, reps=3) -> float:
    walls = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        run()
        _sync()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def _counted(run):
    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts

    _sync()
    dist.barrier()
    reset_launch_counts()
    ops.reset_dispatch_report()
    out = run()
    _sync()
    for op, entry in ops.dispatch_report().items():
        if entry["fallbacks"]:
            raise AssertionError(f"{op} fell back: {entry['fallbacks']}")
    coll = {}
    for c in ops.collective_report():
        key = f"{c['kind']}:{c['axis']}"
        coll[key] = coll.get(key, 0) + c["count"]
    return out, launch_counts(), coll


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", required=True, metavar="DxM")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    smoke = args.device == "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import ops
    from repro_torch.configs import get
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.configs import m3vit as MV
    from repro_torch.core import moe as moe_lib
    from repro_torch.dist.sharding import use_rules
    from repro_torch.kernels.compare import max_abs_err, within_tolerance
    from repro_torch.launch.serve import mesh_rules
    from repro_torch.models import model as LM
    from repro_torch.models.vit import init_params
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.serve.vision import M3ViTServer

    rules, dev, _ = mesh_rules(args.mesh, torch.device(args.device))
    rank = dist.get_rank()

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    if not smoke:
        say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip())
    say(f"mesh {args.mesh} over {dist.get_world_size()} ranks, "
        f"{dist.get_backend()}; torch {torch.__version__}")
    policy = ops.policy_named("cuda")

    cfg = replace(MV.SMOKE_CONFIG if smoke else MV.CONFIG, policy=policy)
    params = init_params(0, cfg, device=dev)
    imgs = np.random.default_rng(0).normal(
        size=(8, MV.IMAGE_H, MV.IMAGE_W, 3)).astype(np.float32)
    plain = M3ViTServer(cfg, params, device=dev)
    mesh = M3ViTServer(cfg, params, rules=rules, resident_fraction=0.5,
                       device=dev)
    for task in MV.TASKS:
        want = plain.infer(imgs, task)
        mesh.infer(imgs, task)                          # warm-up
        got, counts, coll = _counted(lambda: mesh.infer(imgs, task))
        same = np.array_equal(got, want)
        say(f"M3ViT {task} batch 8, paged 0.5 expert-parallel: bit-equal "
            f"to no mesh {same}; launches {json.dumps(counts)}; "
            f"collectives {json.dumps(coll)}")
        if not same:
            raise AssertionError(f"rank {rank}: M3ViT {task} differs")
    st = mesh.cache_stats()
    say(f"  walls semseg: {_wall_ms(lambda: mesh.infer(imgs, 'semseg')):.3f}"
        f" ms with the mesh, "
        f"{_wall_ms(lambda: plain.infer(imgs, 'semseg')):.3f} ms without; "
        f"shard_load {st['shard_load']} imbalance "
        f"{st['shard_load_imbalance']:.3f}, hit_rate {st['hit_rate']:.3f}")

    layer = plain.layer_params[1]["moe"]
    g = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn((8, 128, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    with ops.use_policy(policy):
        want, _ = moe_lib.apply_moe(layer, plain.mcfg, h)
        ep = replace(plain.mcfg, impl="ep_local")
        with use_rules(rules):
            got, counts, coll = _counted(
                lambda: moe_lib.apply_moe(layer, ep, h))
    ok = bool(within_tolerance(got[0], want, torch.bfloat16))
    say(f"apply_moe_ep_local against grouped: max abs err "
        f"{max_abs_err(got[0], want):.3e}, within the bf16 tolerance {ok}; "
        f"launches {json.dumps(counts)}; collectives {json.dumps(coll)}")
    if not ok:
        raise AssertionError(f"rank {rank}: ep_local outside tolerance")
    del plain, mesh, params

    pol = policy.with_impls(attention_decode="cuda_fused")
    lcfg = LL.SMOKE_CONFIG if smoke else LL.CONFIG
    lparams = LM.init_params(0, lcfg, device=dev, draw_on_device=not smoke)
    scfg = ServeConfig(max_len=512, policy=pol)
    plain = ServingEngine(lcfg, lparams, scfg, device=dev)
    mesh = ServingEngine(lcfg, lparams, scfg, rules=rules, device=dev)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, lcfg.vocab_size, size=(8, 128))).to(dev)
    want = plain.generate(prompts, 32)
    mesh.generate(prompts, 2)
    got, counts, coll = _counted(lambda: mesh.generate(prompts, 32))
    same = np.array_equal(got, want)
    say(f"Llama-3.2-1B 8 x 128 prompts, 32 greedy tokens: tokens equal to "
        f"no mesh {same}; launches {json.dumps(counts)}; collectives "
        f"{json.dumps(coll)}")
    say(f"  walls generate: {_wall_ms(lambda: mesh.generate(prompts, 32)):.1f}"
        f" ms with the mesh, "
        f"{_wall_ms(lambda: plain.generate(prompts, 32)):.1f} ms without")
    if not same:
        raise AssertionError(f"rank {rank}: Llama tokens differ")
    del plain, mesh, lparams
    if not smoke:
        torch.cuda.empty_cache()

    # a MoE LM whose routing groups span the data ranks: a prefill's 1024
    # tokens and a decode step's 8 are one 4096-token group each, routed
    # whole on every rank from the gathered router logits
    # (core/moe.py:route_split); the staged expert layer by name, as
    # ``cuda`` names no moe_ffn impl
    scout = get("llama4_scout_17b_a16e", smoke=smoke)
    if not smoke:
        scout = replace(scout, num_layers=SCOUT_LAYERS)
    sparams = LM.init_params(0, scout, device=dev, draw_on_device=not smoke)
    scfg = ServeConfig(max_len=512, policy=pol.with_impls(moe_ffn="eager"))
    plain = ServingEngine(scout, sparams, scfg, device=dev)
    mesh = ServingEngine(scout, sparams, scfg, rules=rules, device=dev)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, scout.vocab_size, size=(8, 128))).to(dev)
    want = plain.generate(prompts, 32)
    mesh.generate(prompts, 2)
    got, counts, coll = _counted(lambda: mesh.generate(prompts, 32))
    same = np.array_equal(got, want)
    say(f"Llama-4-Scout ({scout.num_layers} layers) 8 x 128 prompts, 32 "
        f"greedy tokens: tokens equal to no mesh {same}; launches "
        f"{json.dumps(counts)}; collectives {json.dumps(coll)}")
    say(f"  walls generate: {_wall_ms(lambda: mesh.generate(prompts, 32)):.1f}"
        f" ms with the mesh, "
        f"{_wall_ms(lambda: plain.generate(prompts, 32)):.1f} ms without")
    if not same:
        raise AssertionError(f"rank {rank}: Scout tokens differ")
    dist.barrier()
    dist.destroy_process_group()
    say("MESH_CARDS_OK")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    main()
