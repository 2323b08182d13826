"""The four examples of the JAX package, ported: each a module run with
``python -m repro_torch.examples.<name>``, on the card unless ``--device
cpu`` is given.

  * ``quickstart``    — the paper's five techniques, then M³ViT's two tasks.
  * ``multitask_vit`` — train M³ViT, then switch its task on every frame.
  * ``serve_lm``      — three LM families through one serving engine.
  * ``train_lm``      — a ~100M-parameter LM through the training loop.

Each takes the reference script's flags plus ``--device`` (default: the
card; ``cpu`` runs every kernel module's plain version) and ``--policy``
(a compute-policy preset, default ``cuda``), prints the reference's
lines, and ``main(argv)`` returns the printed numbers as a dict.  Walls
are host walls taken after ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import torch

POLICIES = ("eager", "blocked", "cuda", "cuda_fused", "ref")

__all__ = ["POLICIES", "add_common_flags", "device_of", "policy_of",
           "sync"]


def add_common_flags(ap) -> None:
    """``--device`` and ``--policy``, the port's counterpart of choosing a
    backend."""
    ap.add_argument("--device", default="cuda",
                    help="where to run (default: the card; 'cpu' runs "
                         "every kernel module's plain version)")
    ap.add_argument("--policy", default="cuda", choices=POLICIES,
                    help="compute-policy preset (default: cuda, the "
                         "hand-written kernels)")


def policy_of(args):
    """The ``--policy`` preset.  Under ``cuda`` an MoE layer is staged by
    name (``moe_ffn="eager"``: the preset names no ``moe_ffn`` kernel but
    the fused one, which refuses gradients), so its grouped GEMMs run on
    ``moe_gemm`` and the dispatch report records no fallback."""
    from repro_torch.ops import policy_named

    policy = policy_named(args.policy)
    if args.policy == "cuda":
        policy = policy.with_impls(moe_ffn="eager")
    return policy


def device_of(args) -> torch.device:
    """``--device`` as a device, refusing a missing card; on the card the
    kernels are built (at first use otherwise) before any clock starts."""
    from repro_torch import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import build

        print(f"[examples] kernels built and loaded in "
              f"{build.build_seconds():.1f} s (no compile step after)")
    return dev


def sync(dev) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
