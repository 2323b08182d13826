"""The paper's headline scenario: real-time multi-task ViT with
zero-overhead task switching (Edge-MoE Fig. 1 / §IV-F), the port of the
JAX package's ``examples/multitask_vit.py``.

Trains M³ViT briefly on synthetic Cityscapes-shaped scenes (semantic
segmentation + depth estimation — the paper's two tasks), then alternates
tasks per frame the way the on-board demo does, timing each frame and
showing that the switch moves no weight: every parameter keeps its
storage, and the card's allocated memory is the same before and after.
On the card the four forward kernels train through their autograd
Functions.

    PYTHONPATH=src python -m repro_torch.examples.multitask_vit --smoke \\
        --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.examples.multitask_vit --steps 30
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs.m3vit import TASKS
from repro_torch.examples import (add_common_flags, device_of, policy_of,
                                  sync)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (fast)")
    ap.add_argument("--frames", type=int, default=12)
    add_common_flags(ap)
    return ap


def config(args):
    """M³ViT (paper or ``--smoke``) under ``--policy``."""
    from repro_torch.configs import get

    return replace(get("m3vit", smoke=args.smoke), policy=policy_of(args))


def stream():
    from repro_torch.data import DataConfig, SyntheticM3ViTStream

    return SyntheticM3ViTStream(DataConfig(batch=2, seq_len=0, kind="m3vit"))


def train_step_for(cfg, ocfg):
    """One AdamW step on semseg + depth of one batch: (params, opt,
    semseg loss, depth loss), the reference's jitted ``train_step``."""
    from repro_torch.models import vit
    from repro_torch.optim import adamw_update
    from repro_torch.train.step import loss_and_grads

    def train_step(params, opt, image, semseg, depth):
        parts = []

        def loss_fn(p, b):
            ls, _ = vit.multitask_loss(p, b["image"], b["semseg"], cfg,
                                       "semseg")
            ld, _ = vit.multitask_loss(p, b["image"], b["depth"], cfg,
                                       "depth")
            parts.append((ls.detach(), ld.detach()))
            return ls + ld, None

        _, g = loss_and_grads(loss_fn, params, {"image": image,
                                                "semseg": semseg,
                                                "depth": depth})
        with torch.no_grad():
            params, opt, _ = adamw_update(params, g, opt, ocfg)
        return (params, opt) + parts[0]

    return train_step


def run(args, cfg, dev, params=None) -> dict:
    """Train, then the demo loop; ``params`` (default ``init_params(0,
    cfg)``) start the training."""
    from repro_torch.models import vit
    from repro_torch.optim import OptConfig, adamw_init

    if params is None:
        params = vit.init_params(0, cfg, device=dev)
    params = {k: v.to(dev) for k, v in params.items()}
    data = stream()
    ocfg = OptConfig(lr=3e-3, warmup_steps=5, total_steps=args.steps,
                     weight_decay=0.0)
    opt = adamw_init(params, ocfg)
    train_step = train_step_for(cfg, ocfg)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    print(f"[multitask] training M³ViT ({'smoke' if args.smoke else 'paper'} "
          f"config) on synthetic Cityscapes scenes…")
    losses, step_walls = [], []
    for i in range(args.steps):
        b = data.batch(i % 4)
        sync(dev)
        t0 = time.perf_counter()
        params, opt, ls, ld = train_step(params, opt, put(b["image"]),
                                         put(b["semseg"]), put(b["depth"]))
        losses.append((float(ls), float(ld)))
        step_walls.append(time.perf_counter() - t0)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"  step {i:3d}: semseg_ce={losses[-1][0]:.3f} "
                  f"depth_rmse={losses[-1][1]:.4f}")

    # ---- serving with per-frame task switch (the paper's demo loop)
    def infer(task, frame):
        with torch.inference_mode():
            return vit.forward(params, frame, cfg, task)[0]

    frame = put(data.batch(99)["image"][:1])
    for t in TASKS:
        infer(t, frame)                 # warm both tasks once
    sync(dev)
    pointers = {k: v.data_ptr() for k, v in params.items()}
    allocated = torch.cuda.memory_allocated(dev) if dev.type == "cuda" \
        else None
    times = {t: [] for t in TASKS}
    for i in range(args.frames):
        task = "semseg" if i % 2 == 0 else "depth"   # switch EVERY frame
        t0 = time.perf_counter()
        out = infer(task, frame)
        sync(dev)
        times[task].append(time.perf_counter() - t0)
        del out
    same_storage = {k: v.data_ptr() for k, v in params.items()} == pointers
    after = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    same_memory = None if after is None else after == allocated
    b = data.batch(99)
    pred = infer("semseg", frame).argmax(-1).cpu().numpy()
    acc = float((pred[0] == b["semseg"][0]).mean())
    print(f"[multitask] alternating tasks per frame ({args.frames} frames):")
    moved = "no weight moved" if same_storage and same_memory is not False \
        else "WEIGHTS MOVED"
    for t, ts in times.items():
        print(f"  {t:7s}: {np.mean(ts)*1e3:6.1f} ms/frame "
              f"(±{np.std(ts)*1e3:.1f}) — {moved} on switch")
    mem = "" if after is None else (f"; allocated {allocated} B before, "
                                    f"{after} B after")
    print(f"  task switch: {len(pointers)} parameters, storage unchanged: "
          f"{same_storage}{mem}")
    print(f"  semseg pixel acc on synthetic scene: {acc:.1%}")
    return {"losses": losses, "step_walls_s": step_walls,
            "frame_s": times, "same_storage": same_storage,
            "same_memory": same_memory, "accuracy": acc, "pred": pred}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device_of(args)
    return run(args, config(args), dev)


if __name__ == "__main__":
    main()
