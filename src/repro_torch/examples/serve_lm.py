"""Batched LM serving with KV caches / recurrent state, the port of the JAX
package's ``examples/serve_lm.py``.

Serves three architecture families through the same engine — full-attention
(llama3.2 reduced), attention-free xLSTM, and the RG-LRU hybrid — showing
the per-family decode state (KV cache vs O(1) recurrent state).  On the
card: ``unified_linear``, ``flash_attention`` and ``decode_fused``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --tokens 24
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch

from repro_torch.examples import (add_common_flags, device_of, policy_of,
                                  sync)

ARCHS = ("llama3_2_1b", "xlstm_350m", "recurrentgemma_9b")
MAX_LEN, PROMPT_LEN = 128, 8


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    add_common_flags(ap)
    return ap


def serve_policy(args):
    """``--policy``; ``cuda`` decodes on ``cuda_fused`` (the decode kernel
    reads each slot's own cache length), as the serving launcher does."""
    policy = policy_of(args)
    if args.policy == "cuda":
        policy = policy.with_impls(attention_decode="cuda_fused")
    return policy


def prompts_for(cfg, batch: int) -> torch.Tensor:
    """(batch, 8) token ids from a CPU ``torch.Generator`` seeded 1."""
    g = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (batch, PROMPT_LEN), generator=g)


def state_bytes(cfg, batch: int, device="meta") -> int:
    """Bytes of the decode state ``init_state`` makes on ``device`` for
    ``batch`` slots of ``MAX_LEN`` tokens (on ``meta`` nothing is
    allocated)."""
    from repro_torch.models import model as M
    from repro_torch.tree import flatten

    state = M.init_state(cfg, batch, MAX_LEN, device=device)
    return sum(x.numel() * x.element_size() for x in flatten(state).values())


def serve_arch(cfg, params, prompts, tokens: int, policy, dev) -> dict:
    """Greedy ``tokens`` new tokens for ``prompts`` through one engine:
    the tokens, the host wall (to the tokens on the host), the decode
    state's kind and bytes on ``dev``, and the engine and prompts."""
    from repro_torch.serve import ServeConfig, ServingEngine

    engine = ServingEngine(cfg, params, ServeConfig(max_len=MAX_LEN,
                                                    policy=policy),
                           device=dev)
    sync(dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts, tokens)
    wall = time.perf_counter() - t0
    kind = ("KV cache" if cfg.family in ("dense", "moe", "audio", "vlm")
            else "recurrent state")
    return {"tokens": out, "wall_s": wall, "kind": kind,
            "state_bytes": state_bytes(cfg, prompts.shape[0], dev),
            "engine": engine, "prompts": prompts}


def main(argv=None) -> dict:
    from repro_torch.configs import get
    from repro_torch.models import model as M

    args = parser().parse_args(argv)
    dev = device_of(args)
    policy = serve_policy(args)
    results = {}
    for arch in ARCHS:
        cfg = replace(get(arch, smoke=True), policy=policy)
        params = M.init_params(0, cfg, device=dev)
        r = serve_arch(cfg, params, prompts_for(cfg, args.batch),
                       args.tokens, policy, dev)
        dt, state_mb = r["wall_s"], r["state_bytes"] / 1e6
        r["tok_per_s"] = args.batch * args.tokens / dt
        print(f"[{arch:18s}] {args.batch}×{args.tokens} tokens in {dt:5.2f}s "
              f"({r['tok_per_s']:6.1f} tok/s, no compile step) | "
              f"decode state = {r['kind']}, {state_mb:.1f} MB")
        print(f"  sample: {r['tokens'][0][:12].tolist()}")
        results[arch] = r
    return results


if __name__ == "__main__":
    main()
