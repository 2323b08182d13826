"""The dry-run on one H100, on the ``meta`` device: does each cell fit, and
what is its roofline?  The port of ``repro.launch.dryrun`` for one card.

For every (architecture × input shape) cell of ``configs.cells()`` this
script:

  1. builds the step the cell runs — the training step (loss, gradients
     over ``--accum`` microbatches, AdamW with ``opt_config_for``'s rule)
     for train shapes, the prefill or decode serving step for the others;
  2. runs it on ``meta`` tensors (``models.model.param_specs`` /
     ``input_specs``: shapes and dtypes, no values, no memory) under the
     cost counter (``roofline/op_cost.py``), under the ``cuda`` policy
     (what the card runs; the kernel wrappers run their plain versions
     on ``meta``);
  3. records the roofline report (``roofline/analysis.py``), the argument
     bytes (parameters, optimizer state, inputs and state), the output
     bytes (the new tensors the step returns), the peak live bytes (the
     run's allocations, outputs included) and whether arguments plus peak
     fit the card's memory (``launch/mesh.HW.HBM_BYTES``);
  4. writes one JSON a cell to ``--out``.

Nothing runs on a card: the numbers are counts from shapes, and the
"fits" verdict is the port's own allocations on meta, not a measurement.

``--mesh 16x16`` (or ``2x16x16``; ``--multi-pod`` is the latter) runs
**rank 0's share** of the step on the reference's production mesh, a
device-free ``dist.spmd.VirtualMesh`` (``launch/mesh.py``): a train cell
holds the parameters and AdamW state at their local shapes under
``ShardingRules`` (``--no-fsdp``, ``--fsdp-moe-only``, ``--seq-shard``
as the reference's flags), takes the batch's local rows and gathers its
weights over ``data`` through the mesh, whose collectives are recorded
and counted (``collective_bytes``, ``collectives`` by kind: the bytes a
rank receives).  A serve cell holds a rank's blocks over ``model`` and
its local rows.  In both the dense blocks are tensor-parallel over
``model`` (a rank's heads, hidden columns and vocabulary block; k/v
whole where the KV heads do not divide the axis), so per-rank dense
FLOPs are the one-card count over the batch shards and the model axis,
with the whole k/v repeated on every model rank; a train cell's loss is
vocab-parallel.  What the port runs differs from the reference's GSPMD
program in what the record says (``mesh_note``): activations carry no
layout, so ``--seq-shard`` counts equal those without.  The default
``--mesh 1`` is one card, as before.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3_2_1b --shape train_4k \
      --mesh 16x16 [--no-fsdp | --fsdp-moe-only] [--seq-shard]
  python -m repro_torch.launch.dryrun --all [--out results/dryrun_torch]
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from dataclasses import replace

import torch

from repro_torch import configs, ops
from repro_torch.dist import spmd
from repro_torch.dist.sharding import ShardingRules, use_rules
from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.quant import tree_bytes
from repro_torch.roofline.analysis import analyze_step, kernel_adjusted_terms
from repro_torch.serve.engine import fsdp_gathers, place_params
from repro_torch.train.step import TrainConfig, make_serve_step, \
    make_train_step

__all__ = ["TRAIN_ACCUM", "MESHES", "MESH_NOTE", "opt_config_for",
           "mesh_named", "build_cell", "run_cell", "main"]

# grad-accumulation per train cell (the reference's)
TRAIN_ACCUM = 8
POLICY = "cuda"     # the impls the card runs

MESHES = ("1", "16x16", "2x16x16")
MESH_NOTE = ("rank 0's share on a device-free mesh: the dense blocks and "
             "the recurrent mixers are "
             "tensor-parallel over model in training and in serving (a "
             "rank's heads, hidden columns and vocabulary block, its block "
             "of an RG-LRU mixer's width and its state's, k/v whole "
             "where the KV heads do not divide the axis, the xLSTM mixers "
             "whole where model does not divide their heads), so a cell's "
             "dense "
             "FLOPs and the weights it computes with drop by the model "
             "axis too and its model all-reduces are counted (each block's "
             "in the forward, a train cell's backward all-reduces of the "
             "blocks' inputs and of the whole k/v's weight gradients, and "
             "its vocab-parallel loss's (B, S) "
             "reduces, a serving cell's logits all-gather); a train cell "
             "gathers its split weights over data alone (FSDP), whole "
             "ones over model too; a serving cell holds its weights where "
             "the rules place them (place_params: under FSDP every leaf at "
             "its block over data and model, so its argument bytes are "
             "those blocks, and each layer's leaves are gathered just "
             "before the layer runs, over data and, for a leaf computed "
             "whole, over model: the all-gathers counted under the "
             "fsdp_gather scope; under --no-fsdp the blocks over model "
             "alone, nothing gathered); activations carry no layout, so "
             "--seq-shard counts equal those without")


def mesh_named(name: str):
    """``--mesh``'s value as a device-free mesh (None for one card)."""
    if name not in MESHES:
        raise ValueError(f"--mesh {name!r}: one of {MESHES}")
    return None if name == "1" else make_production_mesh(
        multi_pod=name == "2x16x16")


def opt_config_for(cfg: ArchConfig) -> OptConfig:
    big = cfg.param_count() > 3e10
    # >30B params: bf16 momentum + factored second moment (the reference's)
    return OptConfig(momentum_dtype="bfloat16" if big else "float32",
                     factored=big)


def _fsdp(variant: dict):
    if variant.get("no_fsdp"):
        return False
    return "moe_only" if variant.get("fsdp_moe_only") else True


def build_cell(arch: str, shape_name: str, variant: dict | None = None,
               *, smoke: bool = False, shape=None, device="meta",
               mesh=None):
    """(step function, its arguments, cfg, shape) for one cell, every
    argument on ``device`` (``meta``: shapes only).  ``variant``:
    ``moe_impl`` (str), ``accum`` (int), ``no_remat`` (bool),
    ``attn_block_k`` (int: blocked attention, the impl that takes the
    block, with that ``block_k`` through ``ComputePolicy.with_tiles``, as
    the reference's does), and on a mesh ``no_fsdp``, ``fsdp_moe_only``,
    ``seq_shard`` (bools: the rules' options).  ``smoke`` takes the arch's
    ``SMOKE_CONFIG``; ``shape`` (a ``Shape``) replaces
    ``SHAPES[shape_name]`` (the tests' tiny cells).  ``mesh`` (a
    ``VirtualMesh``): rank 0's share of the step on it."""
    variant = variant or {}
    cfg = configs.get(arch, smoke=smoke)
    if variant.get("moe_impl") and cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, impl=variant["moe_impl"]))
    if variant.get("attn_block_k"):
        pol = (cfg.policy or ops.policy_named(POLICY)).with_impls(
            attention="blocked").with_tiles(
                "attention", block_k=variant["attn_block_k"])
        cfg = replace(cfg, policy=pol)
    if variant.get("no_remat"):
        # the port keeps every activation for the backward (it has no
        # rematerialization), so this is the only way it runs
        cfg = replace(cfg, remat=False)
    shape = shape or SHAPES[shape_name]
    rules = None
    b = shape.global_batch
    if mesh is not None:
        rules = ShardingRules.for_mesh(mesh, fsdp=_fsdp(variant),
                                       seq_shard=bool(variant.get(
                                           "seq_shard")))
        b //= spmd.batch_shard(b, rules)[0]
    local = replace(shape, global_batch=b)
    params = M.param_specs(cfg, device=device)
    specs = M.input_specs(cfg, local, device=device)
    if shape.kind == "train":
        ocfg = opt_config_for(cfg)
        tcfg = TrainConfig(opt=ocfg,
                           accum_steps=variant.get("accum") or TRAIN_ACCUM)
        opt_state = adamw_init(params, ocfg)
        step = make_train_step(cfg, tcfg, rules=rules)
        if step.layout is not None:
            params = step.layout.shard_params(params)
            opt_state = step.layout.shard_opt_state(opt_state)
        return step, (params, opt_state, specs), cfg, shape
    # a serving rank's weights where the rules place them (its blocks
    # over model, and over data too under FSDP, each layer's gathered
    # before it runs), its KV heads and its RG-LRU channels (whole
    # without a mesh)
    params = place_params(params, cfg, rules)
    gathers = fsdp_gathers(params, cfg, rules)
    prefill, decode = make_serve_step(cfg, gather=gathers)
    state = M.init_state(cfg, b, shape.seq_len, device=device,
                         params=params, gather=gathers)
    if shape.kind == "prefill":
        fn, args = prefill, (params, specs["inputs"], state)
    else:
        # decode: one new token against a seq_len cache; the scalar index
        # is handed over as every slot's position (a host read of a meta
        # scalar is not possible), which writes and reads the same cache
        # rows
        index = specs["cache_index"].expand(b)
        fn, args = decode, (params, specs["inputs"], state, index)
    if rules is not None:
        fn = _on_mesh(fn, rules, shape.global_batch)
    return fn, args, cfg, shape


def _on_mesh(fn, rules, n: int):
    """A serving step run as one rank's share of a batch of ``n``: under
    the rules, its forward marked as a split of the batch."""
    def run(*args):
        with use_rules(rules), spmd.batch_split(rules, n):
            return fn(*args)
    return run


def run_cell(arch: str, shape_name: str, out_dir: str | None = None,
             verbose: bool = True, variant: dict | None = None,
             tag: str = "", *, smoke: bool = False, shape=None,
             mesh: str = "1") -> dict:
    t0 = time.time()
    vmesh = mesh_named(mesh)
    fn, args, cfg, shape = build_cell(arch, shape_name, variant,
                                      smoke=smoke, shape=shape, mesh=vmesh)
    shape_name = shape.name
    t_build = time.time() - t0
    argument_bytes = tree_bytes(args)
    mesh_kw = {}
    if vmesh is not None:
        rules = ShardingRules.for_mesh(vmesh)
        mesh_kw = dict(mesh=mesh, chips=vmesh.size(), batch_shards=(
            spmd.batch_shard(shape.global_batch, rules)[0]))
    t0 = time.time()
    with ops.use_policy(ops.policy_named(POLICY)):
        report, out = analyze_step(fn, args, cfg, shape, **mesh_kw)
    t_run = time.time() - t0
    arg_keys = {t.untyped_storage()._cdata for t in _leaves(args)}
    output_bytes = sum(t.untyped_storage().nbytes() for t in
                       {t.untyped_storage()._cdata: t
                        for t in _leaves(out)}.values()
                       if t.untyped_storage()._cdata not in arg_keys)
    del out
    rec = report.to_dict()
    rec["kernel_adjusted"] = kernel_adjusted_terms(rec, cfg, shape)
    total = argument_bytes + report.peak_live_bytes
    rec.update(
        arch=arch, shape=shape_name, variant=tag or "baseline",
        policy=POLICY, build_s=t_build, run_s=t_run,
        argument_bytes=float(argument_bytes),
        output_bytes=float(output_bytes),
        temp_bytes=float(report.peak_live_bytes),
        total_bytes=float(total), hbm_bytes=float(HW.HBM_BYTES),
        fits=bool(total <= HW.HBM_BYTES), ok=True,
    )
    rec["bytes_per_device"] = float(total)
    if vmesh is not None:
        v = variant or {}
        rec.update(mesh_note=MESH_NOTE, fsdp=_fsdp(v),
                   seq_shard=bool(v.get("seq_shard")))
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {rec['mesh']} "
              f"(policy {POLICY}): built {t_build:.1f}s, counted "
              f"{t_run:.1f}s")
        print(f"  roofline: compute {report.t_compute*1e3:.2f}ms  "
              f"memory {report.t_memory*1e3:.2f}ms  "
              f"collective {report.t_collective*1e3:.2f}ms  "
              f"-> {report.bottleneck}-bound  "
              f"useful={report.useful_ratio:.2f} "
              f"roofline_frac={report.roofline_fraction:.3f}")
        print(f"  bytes: arguments {argument_bytes/2**30:.2f} GiB, peak "
              f"live {report.peak_live_bytes/2**30:.2f} GiB, outputs "
              f"{output_bytes/2**30:.2f} GiB -> "
              f"{'fits' if rec['fits'] else 'does not fit'} in "
              f"{HW.HBM_BYTES/2**30:.1f} GiB")
        if vmesh is not None:
            print(f"  collectives: {report.collective_bytes/2**30:.3f} GiB "
                  f"a rank receives; {MESH_NOTE}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn_out = os.path.join(out_dir, f"{arch}__{shape_name}__"
                              f"{rec['mesh']}{suffix}.json")
        with open(fn_out, "w") as f:
            json.dump(rec, f, indent=1)
        if verbose:
            print(f"  -> {fn_out}")
    return rec


def _leaves(tree) -> list:
    out, stack = [], [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", help="architecture id (see configs)")
    ap.add_argument("--shape", help="shape id: train_4k | prefill_32k | "
                                    "decode_32k | long_500k")
    ap.add_argument("--all", action="store_true",
                    help="run every runnable cell")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag for the output "
                                              "file")
    ap.add_argument("--moe-impl", default=None,
                    choices=["onehot", "grouped", "ep_local"])
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true",
                    help="keep every activation for the backward (the "
                         "port's only mode)")
    ap.add_argument("--mesh", default="1", choices=MESHES,
                    help="1: one card; 16x16 / 2x16x16: rank 0's share on "
                         "the reference's production mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (--mesh 2x16x16)")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="no weight sharding over data")
    ap.add_argument("--fsdp-moe-only", action="store_true",
                    help="shard only the expert stacks over data")
    ap.add_argument("--seq-shard", action="store_true",
                    help="the rules' sequence sharding (activations carry "
                         "no layout in the port: the counts are unchanged)")
    ap.add_argument("--attn-block-k", type=int, default=None,
                    help="blocked attention with this block_k (a policy "
                         "tile override)")
    args = ap.parse_args(argv)
    mesh = "2x16x16" if args.multi_pod else args.mesh
    mesh_flags = [f for f in ("no_fsdp", "fsdp_moe_only", "seq_shard")
                  if getattr(args, f)]
    if mesh_flags and mesh == "1":
        mesh = "16x16"          # the reference's flags imply its mesh
    variant = {f: True for f in mesh_flags}
    tag = args.tag or "_".join(mesh_flags + (
        [args.moe_impl] if args.moe_impl else []))
    if args.moe_impl:
        variant["moe_impl"] = args.moe_impl
    if args.accum:
        variant["accum"] = args.accum
    if args.no_remat:
        variant["no_remat"] = True
    if args.attn_block_k:
        variant["attn_block_k"] = args.attn_block_k

    if args.list:
        for a, s, runnable in configs.cells(include_skipped=True):
            state = "runnable" if runnable else "SKIP (full attention @500k)"
            print(f"{a:28s} {s:12s} {state}")
        return 0

    if args.all:
        failures = []
        for a, s, runnable in configs.cells():
            if not runnable:
                continue
            try:
                run_cell(a, s, out_dir=args.out, variant=variant,
                         tag=tag, mesh=mesh)
            except Exception as e:
                traceback.print_exc()
                failures.append((a, s, repr(e)))
        if failures:
            print(f"FAILURES: {failures}")
            return 1
        print("all cells OK")
        return 0

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all, or --list")
    run_cell(args.arch, args.shape, out_dir=args.out, variant=variant,
             tag=tag, mesh=mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
