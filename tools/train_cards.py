#!/usr/bin/env python3
"""Training over a mesh across cards, one process a card under
``torchrun`` (NCCL): each rank trains over the mesh and the same steps
with no mesh on its own card, and holds the two against each other.

    python3 -c "from repro_torch.kernels import build; build.build_seconds()"
    torchrun --standalone --nproc-per-node 4 tools/train_cards.py

(build once before ``torchrun``: the ranks then load the same library
instead of compiling it side by side).  ``--device cpu`` runs the same
over gloo with the kernels' plain versions at the models' smoke sizes (a
rehearsal).  Checks, bf16, weights from seed 0, ``make_train_step`` under
``ShardingRules.for_mesh`` (``fsdp=True``), AdamW with eps 1 (a step
proportional to the gradient, so two bf16 sum orders move a parameter by
less than an ulp, where Adam's sign-like first step would move a
near-zero gradient's element by 2·lr):

* Llama-3.2-1B at full width and depth, 8 × 128 tokens, 3 steps, at
  ``1x4`` (tensor-parallel: a quarter of the heads, the MLP's columns
  and the vocabulary a rank, every rank on the whole batch), ``2x2``
  (tensor-parallel over two, FSDP over two, the batch split in two) and
  ``4x1`` (FSDP over ``data``, the batch split in four, the launcher's
  ``--mesh local`` layout): loss and grad norm within
  ``compare.TRAIN_LOSS_RTOL`` of one card, the updated parameters within
  ``compare.py``'s tolerance once a step; where ``model`` splits, the
  collectives over it as counted from the config
  (``chip_smoke._tp_train_expect``: no logits all-gather, no gather over
  ``model`` of a split leaf); peak memory a rank beside one card's; host
  walls a step (steps 1-2: the first starts the NCCL groups); the
  collectives' device ms (``train/profile.py``);
* M³ViT at ``2x2`` with ``moe.impl="ep_local"`` (8 of 16 experts a
  rank; its MLPs tensor-parallel, its three-head attention whole): every
  expert's gradient against one card's ``grouped`` (cosine), and 3 steps
  against one card as above;
* RecurrentGemma-9B at full width and ``RG_LAYERS`` of its 38 layers
  (one Griffin period), 8 × 128 tokens, 3 steps at ``1x4`` (its RG-LRU
  mixers, MLPs, q heads and vocabulary a quarter a rank, its one KV head
  whole), with the reference's large-model AdamW state (bf16 momentum, a
  factored second moment: one card's whole state would not fit beside
  the weights and gradients), against one card as above;
* xLSTM-350M at full width and ``XL_LAYERS`` of its 24 layers (one
  period: 7 mLSTM blocks and 1 sLSTM), 8 × 128 tokens, 3 steps at
  ``1x4`` (one of its 4 heads a rank in every mixer, the vocabulary a
  quarter, the sLSTM's 1365-wide up-projection whole), against one card
  as above, the peak a rank beside one card's.

``--only NAME[,NAME]`` runs some of ``llama``, ``m3vit``,
``recurrentgemma`` and ``xlstm``.  The caching allocator runs with expandable
segments (``PYTORCH_CUDA_ALLOC_CONF``, set here unless the environment
sets it): RecurrentGemma's one-card step's 4 GiB temporaries otherwise
leave GiBs reserved between them.

Rank 0 prints the card's name and power limit, each check's result, the
launches by kernel and the collectives of each mesh run.  Any failed
check raises.
"""

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402  (after the allocator's setting)
import torch.distributed as dist  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import _m3vit_loss as m3vit_loss  # noqa: E402  (the path)
from chip_smoke import TP_WHERE, _tp_train_expect  # noqa: E402

MESH_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1.0,
                weight_decay=0.0)
#: RecurrentGemma-9B's depth here, at full width: one Griffin period (its
#: one-card step peaks at 56 GiB, 2.1 G of its parameters in the
#: vocabulary; at 6 layers it outgrows the card)
RG_LAYERS = 3
XL_LAYERS = 8           # xLSTM-350M's depth here: one period, full width
CHECKS = ("llama", "m3vit", "recurrentgemma", "xlstm")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _peak_reset() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak() -> float:
    return torch.cuda.max_memory_allocated() / 2**30 \
        if torch.cuda.is_available() else 0.0


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
        key = f"{c['kind']}:{c['axis']}:{c['where']}"
        coll[key] = coll.get(key, 0) + c["count"]
    return out, launch_counts(), coll


def _by_axis(coll: dict) -> dict:
    """``kind:axis:where`` counts summed by ``kind:axis``."""
    out: dict = {}
    for k, n in coll.items():
        key = k.rsplit(":", 1)[0]
        out[key] = out.get(key, 0) + n
    return out


def _tp_off(cfg, lay, coll: dict, steps: int, forwards: int) -> dict:
    """The tensor-parallel collectives that differ from the count from
    the config: {``kind:axis:where``: (got, expected)}."""
    want = _tp_train_expect(cfg, lay, forwards, steps)
    keys = set(want) | {k for k in coll if k.startswith("all_gather:model:")
                        or k.split(":", 2)[2] in TP_WHERE}
    return {k: (coll.get(k, 0), want.get(k, 0)) for k in keys
            if coll.get(k, 0) != want.get(k, 0)}


def _steps(step, p, o, batches, place, walls):
    """The steps on ``batches``: (last params, last state, each step's
    (loss, grad norm)); only the newest state is held."""
    metrics = []
    for b in batches:
        _sync()
        t0 = time.perf_counter()
        p, o, m = step(p, o, place(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        walls.append(time.perf_counter() - t0)
    return p, o, metrics


def against_one(label, cfg, params, batches, mesh_shape, dev, say,
                loss_fn=None, profile=True, forwards=1, opt=None):
    """The steps of ``batches`` over the mesh against the same steps on
    one card; the walls leave out the first step (its NCCL groups start
    there).  ``opt``: ``OptConfig`` fields over ``MESH_OPT``."""
    from repro_torch.data import device_transform, shard_for
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.kernels import compare
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.profile import profile_steps

    tcfg = TrainConfig(opt=OptConfig(**{**MESH_OPT, **(opt or {})}))
    put = device_transform(dev)
    mesh = spmd.init_mesh(mesh_shape, device_type=dev.type)
    rules = ShardingRules.for_mesh(mesh)

    single = make_train_step(cfg, tcfg, loss_fn=loss_fn)
    walls1: list = []
    opt = adamw_init(params, tcfg.opt)
    _peak_reset()
    last, opt, want_m = _steps(single, params, opt, batches, put, walls1)
    del opt         # the one-card AdamW state: not held over the mesh run
    want = {k: v.cpu() for k, v in last.items()}
    peak1 = _peak()
    del last
    gc.collect()

    meshed = make_train_step(cfg, tcfg, rules=rules, loss_fn=loss_fn)
    lay = meshed.layout
    blocks = (lay.shard_params(params),
              lay.shard_opt_state(adamw_init(params, tcfg.opt)))
    gc.collect()
    _peak_reset()
    walls2: list = []

    (p, o, got_m), counts, coll = _counted(lambda: _steps(
        meshed, *blocks, batches, lambda b: shard_for(b, rules, dev),
        walls2))
    peak2 = _peak()
    rel = max(abs(a - b) / abs(b) for g, w in zip(got_m, want_m)
              for a, b in zip(g, w))
    with torch.no_grad():
        whole = {k: spmd.gather_param(v, lay.params[k], mesh)
                 for k, v in p.items()}
    steps = len(batches)
    within = all(bool(((whole[k].float() - want[k].to(dev).float()).abs()
                       <= steps * compare.kernel_tolerance(
                           whole[k], want[k].to(dev), want[k].dtype)).all())
                 for k in want)
    prof = None
    if profile and dev.type == "cuda":
        b = shard_for(batches[0], rules, dev)
        prof = profile_steps(lambda: float(meshed(p, o, b)[2]["loss"]), 2,
                             statistics.median(walls2[1:]))
    off = {}
    if spmd.axis_size(mesh, "model") > 1:
        off = _tp_off(cfg, lay, coll, steps, steps * forwards)
    ok = rel <= compare.TRAIN_LOSS_RTOL and within and not off
    say(f"{label} at {'x'.join(map(str, mesh_shape))}, {steps} steps "
        f"against one card: loss and grad norm relative {rel:.3e} (<= "
        f"{compare.TRAIN_LOSS_RTOL}); parameters within {steps} steps of "
        f"compare.py's tolerance: {within}; losses "
        f"{[round(m[0], 5) for m in got_m]}")
    say(f"  peak memory a rank {peak2:.2f} GiB over the mesh (the whole "
        f"weights kept for the comparison included), {peak1:.2f} GiB on "
        f"one card; host walls a step (median of steps 1-{steps - 1}) "
        f"{statistics.median(walls2[1:]) * 1e3:.1f} ms over the mesh, "
        f"{statistics.median(walls1[1:]) * 1e3:.1f} ms on one card")
    say(f"  launches {json.dumps(counts)}; collectives "
        f"{json.dumps(_by_axis(coll))}")
    if spmd.axis_size(mesh, "model") > 1:
        say(f"  tensor-parallel collectives over model by where: "
            f"{json.dumps({k: n for k, n in coll.items() if ':model:' in k})}"
            f"; against the count from the config (no logits all-gather, "
            f"no gather over model of a split leaf): "
            f"{'ok' if not off else off}")
    if prof is not None:
        say(f"  profile of a mesh step (torch.profiler, 2 steps): busy "
            f"{prof['busy_ms']:.1f} ms, collectives "
            f"{prof['collective_ms']:.1f} ms device time, idle share "
            f"{prof['idle_share']:.3f}")
    if not ok:
        raise AssertionError(f"rank {dist.get_rank()}: {label} at "
                             f"{mesh_shape} disagrees with one card")
    del p, o, blocks, whole, want
    gc.collect()
    return counts


def ep_local_grads(cfg, params, batch, dev, say, loss_fn) -> None:
    """Every expert's gradient under ``ep_local`` at 2×2 against one
    card's ``grouped``."""
    from repro_torch.data import device_transform, shard_for
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import ShardingRules, local_slice
    from repro_torch.kernels import compare
    from repro_torch.train import TrainConfig, make_train_step

    mesh = spmd.init_mesh((2, 2), device_type=dev.type)
    rules = ShardingRules.for_mesh(mesh)
    ecfg = replace(cfg, moe=replace(cfg.moe, impl="ep_local"))
    _, want = make_train_step(cfg, TrainConfig(),
                              loss_fn=loss_fn(cfg)).grads(
        params, device_transform(dev)(batch))
    step = make_train_step(ecfg, TrainConfig(), rules=rules,
                           loss_fn=loss_fn(ecfg))
    lay = step.layout
    (_, got), counts, coll = _counted(lambda: step.grads(
        lay.shard_params(params), shard_for(batch, rules, dev)))
    cos = []
    stacks = sorted(k for k in lay.keep if ".moe." in k)   # not the MLPs
    for k in stacks:
        mine = want[k][local_slice(tuple(want[k].shape), lay.params[k],
                                   mesh)]
        for e in range(mine.shape[1]):
            cos.append(compare.cosine(got[k][:, e], mine[:, e]))
    worst = min(cos)
    say(f"M3ViT ep_local at 2x2, {len(cos)} expert gradients a rank over "
        f"{len(stacks)} stacks against one card's grouped: worst cosine "
        f"{worst:.6f} (>= {compare.GRAD_COSINE_LEAF}); launches "
        f"{json.dumps(counts)}; collectives {json.dumps(_by_axis(coll))}")
    if worst < compare.GRAD_COSINE_LEAF:
        raise AssertionError(f"rank {dist.get_rank()}: ep_local gradients")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default=None, metavar="NAME[,NAME]",
                    help=f"run only these checks, of {', '.join(CHECKS)}")
    args = ap.parse_args()
    smoke = args.device == "cpu"
    only = set(args.only.split(",")) if args.only else set(CHECKS)
    if only - set(CHECKS):
        raise SystemExit(f"--only: unknown {sorted(only - set(CHECKS))}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.configs import m3vit as MV
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.launch.train import local_mesh
    from repro_torch.models import model as LM
    from repro_torch.models import vit

    _, dev = local_mesh(argparse.Namespace(mesh="local"),
                        torch.device(args.device))
    rank = dist.get_rank()

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    if not smoke:
        say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip())
    say(f"{dist.get_world_size()} ranks, {dist.get_backend()}; torch "
        f"{torch.__version__}")
    cuda = ops.policy_named("cuda")
    total: dict = {}

    def add(counts):
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c

    if "llama" in only:
        lcfg = replace(LL.SMOKE_CONFIG if smoke else LL.CONFIG, policy=cuda)
        lparams = LM.init_params(0, lcfg, device=dev,
                                 draw_on_device=not smoke)
        stream = make_stream(DataConfig(batch=8, seq_len=128,
                                        vocab_size=lcfg.vocab_size, seed=0))
        batches = [stream.batch(i) for i in range(3)]
        for shape in ((1, 4), (2, 2), (4, 1)):
            add(against_one("Llama-3.2-1B", lcfg, lparams, batches, shape,
                            dev, say))
        del lparams
        gc.collect()
        _peak_reset()

    if "m3vit" in only:
        mcfg = replace(MV.SMOKE_CONFIG if smoke else MV.CONFIG,
                       policy=cuda.with_impls(moe_ffn="eager"))
        mparams = vit.init_params(0, mcfg, device=dev)
        mstream = make_stream(DataConfig(batch=8, seq_len=0, kind="m3vit",
                                         seed=0))
        ep_local_grads(mcfg, mparams, mstream.batch(0), dev, say,
                       m3vit_loss)
        ecfg = replace(mcfg, moe=replace(mcfg.moe, impl="ep_local"))
        add(against_one("M3ViT ep_local", ecfg, mparams,
                        [mstream.batch(i) for i in range(3)], (2, 2), dev,
                        say, loss_fn=m3vit_loss(ecfg), profile=False,
                        forwards=2))
        del mparams
        gc.collect()
        _peak_reset()

    if "recurrentgemma" in only:
        from repro_torch.configs import get

        # the CPU rehearsal at the smoke size runs exact activations: there
        # the LUT GELU's bf16 noise alone takes the loss past the gate,
        # with no model split too (4x1)
        gcfg = replace(get("recurrentgemma_9b", smoke=smoke),
                       policy=ops.policy_named("eager") if smoke else cuda)
        if not smoke:
            gcfg = replace(gcfg, num_layers=RG_LAYERS)
        gparams = LM.init_params(0, gcfg, device=dev,
                                 draw_on_device=not smoke)
        gstream = make_stream(DataConfig(batch=8, seq_len=128,
                                         vocab_size=gcfg.vocab_size, seed=0))
        add(against_one(f"RecurrentGemma-9B ({gcfg.num_layers} layers)",
                        gcfg, gparams, [gstream.batch(i) for i in range(3)],
                        (1, 4), dev, say,
                        opt=dict(momentum_dtype="bfloat16", factored=True)))
        del gparams
        gc.collect()

    if "xlstm" in only:
        from repro_torch.configs import get

        # exact activations in the CPU rehearsal, as RecurrentGemma's
        xcfg = replace(get("xlstm_350m", smoke=smoke),
                       policy=ops.policy_named("eager") if smoke else cuda)
        if not smoke:
            xcfg = replace(xcfg, num_layers=XL_LAYERS)
        xparams = LM.init_params(0, xcfg, device=dev,
                                 draw_on_device=not smoke)
        xstream = make_stream(DataConfig(batch=8, seq_len=128,
                                         vocab_size=xcfg.vocab_size, seed=0))
        add(against_one(f"xLSTM-350M ({xcfg.num_layers} layers)", xcfg,
                        xparams, [xstream.batch(i) for i in range(3)],
                        (1, 4), dev, say))
        del xparams
        gc.collect()
    say(f"launches over the mesh runs (rank 0): {json.dumps(total)}")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
