"""Training launcher, the port of ``repro.launch.train``: the
fault-tolerant ``TrainLoop`` for an ``--arch`` on one device, the card
unless ``--device cpu`` is given.

It builds what the reference builds: seeded parameters, AdamW
(``--lr``, ``--warmup``, ``--steps`` total), ``make_train_step`` with the
LM loss and ``--accum`` microbatches, the counted ``SyntheticLMStream``
(tokens, or embeddings for an embeddings-input arch) put on the device
through page-locked memory, checkpoints every ``--ckpt-every`` steps in
``--ckpt-dir``, resumed from the newest one there.  ``--policy`` names a
compute-policy preset (without it, the registry defaults: the reference's
training policy; ``cuda`` trains through the kernels, whose backward is
written out in ``torch.autograd`` Functions).

``--mesh local`` trains over a 1-D ``("data",)`` mesh of every process
of the world, under ``ShardingRules.for_mesh`` (FSDP, the reference's
default): the rules go to ``make_train_step`` (the reference's launcher
builds them but never passes them), each rank holds its blocks of the
parameters and optimizer state and takes its rows of every batch
(``data.shard_for``), checkpoints hold the whole tree, and rank 0 logs.
The process group is started here from ``torchrun``'s environment (NCCL
on the cards, one a process by ``LOCAL_RANK``; gloo with ``--device
cpu``) unless one exists already; one process outside ``torchrun`` trains
as the reference does on one device, with no rules, and says so.

Usage:
  python -m repro_torch.launch.train --arch llama3_2_1b --smoke --steps 100 \\
      --device cpu
  python -m repro_torch.launch.train --arch llama3_2_1b --steps 5 \\
      --batch 4 --seq-len 128 --policy cuda
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3_2_1b --steps 5 --batch 8 --policy cuda --mesh local
"""

from __future__ import annotations

import argparse
from dataclasses import replace

POLICIES = ("eager", "blocked", "cuda", "ref")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="where to train (default: the card; 'cpu' runs "
                         "every kernel module's plain version)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default=None, choices=POLICIES,
                    help="compute-policy preset (default: the registry "
                         "defaults, the reference's training policy)")
    ap.add_argument("--mesh", choices=["none", "local"], default="none",
                    help="'local': a 1-D data mesh over the world's "
                         "processes (torchrun), FSDP rules")
    return ap


def opt_config(args):
    from repro_torch.optim import OptConfig

    return OptConfig(lr=args.lr, warmup_steps=args.warmup,
                     total_steps=args.steps)


def train_step_for(cfg, args, rules=None):
    """The LM train step ``main`` runs, for ``cfg`` (its policy decides
    where the ops run), over ``rules``' mesh where given."""
    from repro_torch.train import TrainConfig, make_train_step

    return make_train_step(cfg, TrainConfig(opt=opt_config(args),
                                            accum_steps=args.accum),
                           rules=rules)


def local_mesh(args, dev):
    """``--mesh local``: (rules, this rank's device) over a ``("data",)``
    mesh of the world, the group started from ``torchrun``'s environment
    where none exists; (None, dev) for one process outside ``torchrun``."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.dist.spmd import init_mesh

    if args.mesh == "none":
        return None, dev
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            print("[train] --mesh local outside torchrun: one process, no "
                  "sharding rules (the reference's one device)")
            return None, dev
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                          "0")))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    mesh = init_mesh((dist.get_world_size(),), ("data",),
                     device_type=dev.type)
    return ShardingRules.for_mesh(mesh), dev


def build(args):
    """(cfg, params, opt_state, step, stream, device, rules) as ``main``
    trains them: the arch's config under ``--policy``, seeded parameters
    on the device, the AdamW state, the LM train step and the token
    stream; under ``--mesh local`` the rules, and the parameters and
    state as this rank's blocks."""
    from repro_torch import resolve_device
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.models import model as M
    from repro_torch.ops import policy_named
    from repro_torch.optim import adamw_init

    rules, dev = local_mesh(args, resolve_device(args.device))
    cfg = get(args.arch, smoke=args.smoke)
    if args.policy is not None:
        cfg = replace(cfg, policy=policy_named(args.policy))
    params = M.init_params(args.seed, cfg, device=dev)
    opt_state = adamw_init(params, opt_config(args))
    step = train_step_for(cfg, args, rules)
    if step.layout is not None:
        params = step.layout.shard_params(params)
        opt_state = step.layout.shard_opt_state(opt_state)
    stream = make_stream(DataConfig(
        batch=args.batch, seq_len=args.seq_len,
        vocab_size=cfg.vocab_size if cfg.embed_input == "tokens" else 0,
        d_model=cfg.d_model, seed=args.seed))
    return cfg, params, opt_state, step, stream, dev, rules


def run(argv=None):
    """Train as ``main`` does; returns the finished ``TrainLoop``."""
    import functools

    args = parser().parse_args(argv)
    from repro_torch.data import device_transform, shard_for
    from repro_torch.models import model as M
    from repro_torch.train import LoopConfig, TrainLoop

    cfg, params, opt_state, step, stream, dev, rules = build(args)
    n_params = sum(s.numel() for s in M.param_specs(cfg).values())
    if rules is None:
        put = device_transform(dev)
        where = f"device={dev}"
    else:
        put = functools.partial(shard_for, rules=rules, device=dev,
                                accum_steps=args.accum)
        where = (f"mesh=data:{rules.mesh.shape[0]} device={dev} "
                 f"(fsdp, rank {rules.mesh.get_local_rank('data')})")
    loop = TrainLoop(
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every),
        step, stream, params, opt_state, batch_transform=put,
        layout=step.layout)
    loop.log(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M "
             f"{where}")
    loop.try_restore()
    st = loop.run()
    if st.history:
        loop.log(f"[train] done: loss {st.history[0][1]:.4f} -> "
                 f"{st.history[-1][1]:.4f} over {st.step} steps "
                 f"(stragglers={st.straggler_count}, "
                 f"nan_skips={st.nan_skip_count})")
    return loop


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
