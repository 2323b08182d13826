"""Quickstart: the paper's five techniques as composable PyTorch modules,
the port of the JAX package's ``examples/quickstart.py``.

Demonstrates each Edge-MoE technique in isolation, then the full M³ViT
multi-task model using all of them (on the card: ``unified_linear``,
``flash_attention``, ``gelu_lut`` and ``moe_gemm``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart   # the card
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
    add_common_flags(ap)
    return ap


def m3vit_frame(device) -> torch.Tensor:
    """One (1, 128, 256, 3) frame drawn by a CPU ``torch.Generator``
    seeded 1, on ``device``."""
    from repro_torch.configs import m3vit as MV

    g = torch.Generator().manual_seed(1)
    img = torch.randn((1, MV.IMAGE_H, MV.IMAGE_W, 3), generator=g)
    return img.to(device)


def m3vit_tasks(params, img, cfg, dev) -> dict:
    """Each task's prediction and first-call wall (there is no compile
    step: the first call is the call)."""
    from repro_torch.models import vit

    out = {}
    for task in TASKS:
        sync(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            pred = vit.forward(params, img, cfg, task)[0]
        sync(dev)
        out[task] = (pred, time.perf_counter() - t0)
    return out


def main(argv=None) -> dict:
    from repro_torch import ops
    from repro_torch.configs import get
    from repro_torch.core import attention, gelu, online_softmax, routing
    from repro_torch.core.unified_linear import unified_linear
    from repro_torch.models import vit

    args = parser().parse_args(argv)
    dev = device_of(args)
    policy = policy_of(args)
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # ① attention reordering — blocked streaming == naive, at constant bw
    q = put(rng.normal(size=(1, 4, 128, 64)))
    k = put(rng.normal(size=(1, 4, 128, 64)))
    v = put(rng.normal(size=(1, 4, 128, 64)))
    o_naive = attention.naive_attention(q, k, v, causal=False)
    o_blocked = attention.blocked_attention(q, k, v, causal=False,
                                            block_k=32)
    m = attention.bandwidth_model(n=128, p=4)
    attn_diff = float((o_naive - o_blocked).abs().max())
    print(f"① attention reordering: max|Δ|={attn_diff:.2e}, "
          f"loads {m.loads_without_reorder} → {m.loads_with_reorder} "
          f"(bandwidth {m.bandwidth_without_reorder:.1f} → "
          f"{m.bandwidth_with_reorder:.2f} blocks/cycle)")

    # ② single-pass softmax — overflow-proof, one pass (Algorithm 1)
    x = torch.tensor([88.0, 90.0, 7.0, -3.0], device=dev)  # exp(90) overflows
    b, s = online_softmax.online_max_sum(x)
    matches = bool(torch.allclose(online_softmax.softmax(x),
                                  torch.softmax(x, dim=-1)))
    print(f"② single-pass softmax: bias={float(b):.0f} denom={float(s):.4f} "
          f"(finite despite exp(90)); matches torch.softmax: {matches}")

    # ③ LUT GELU — ReLU − δ(|x|), half-table, truncated, bit-shift index
    xs = put(np.linspace(-8, 8, 100001))
    err = float((gelu.lut_gelu(xs) - gelu.exact_gelu(xs)).abs().max())
    table = gelu.build_delta_table("gelu")
    print(f"③ LUT GELU: table={table.shape[0]} entries "
          f"({table.shape[0]*4/1024:.0f} KiB), max|err|={err:.1e}")

    # ④ unified linear — one GEMM path (+ fused LUT epilogue) for everything
    xw = put(rng.normal(size=(128, 192)))
    w = put(rng.normal(size=(192, 768)))
    with ops.use_policy(policy):
        y = unified_linear(xw, w, activation="gelu")  # LUT in the epilogue
    print(f"④ unified linear: fused GEMM+bias+LUT-GELU -> "
          f"{tuple(y.shape)}")

    # ⑤ expert-by-expert reordering — queues, metaqueue, weighted combine
    logits = put(rng.normal(size=(128, 16)))
    r = routing.route(logits, k=4, capacity=64)
    sizes = np.bincount(r.expert.cpu().numpy().ravel(), minlength=16)
    print(f"⑤ expert-by-expert: queues per expert {sizes.tolist()} "
          f"(metaqueue skips {int((sizes == 0).sum())} empty)")

    # all together: the paper's M³ViT, multi-task, zero-overhead task switch
    cfg = replace(get("m3vit"), policy=policy)
    params = vit.init_params(0, cfg, device=dev)
    tasks = m3vit_tasks(params, m3vit_frame(dev), cfg, dev)
    for task, (pred, wall) in tasks.items():
        print(f"   M³ViT[{task}]: {tuple(pred.shape)} in {wall:.2f}s "
              f"(first call; no compile step)")
    print("done.")
    return {
        "attn_max_diff": attn_diff,
        "loads": (m.loads_without_reorder, m.loads_with_reorder),
        "bandwidth": (m.bandwidth_without_reorder,
                      m.bandwidth_with_reorder),
        "softmax_bias": float(b), "softmax_denom": float(s),
        "softmax_matches": matches,
        "lut_entries": int(table.shape[0]), "lut_max_err": err,
        "linear_shape": tuple(y.shape), "linear_out": y,
        "linear_args": (xw, w),
        "queue_sizes": sizes.tolist(),
        "empty_queues": int((sizes == 0).sum()),
        "m3vit": {task: pred for task, (pred, _) in tasks.items()},
        "m3vit_wall_s": {task: wall for task, (_, wall) in tasks.items()},
    }


if __name__ == "__main__":
    main()
