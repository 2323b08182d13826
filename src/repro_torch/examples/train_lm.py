"""End to end: train a ~100M-parameter LM for a few hundred steps,
the port of the JAX package's ``examples/train_lm.py``.

Uses the full training stack — counted data stream, train step with
gradient accumulation, AdamW, atomic async checkpoints, straggler
detection, restart-safe loop.  Kill it mid-run and re-launch: it resumes
from the newest checkpoint and replays the exact batch sequence.  On the
card ``unified_linear`` and ``flash_attention`` run forward and backward.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 20  # smoke
"""

from __future__ import annotations

import argparse
import os
import tempfile
from dataclasses import replace

from repro_torch.examples import add_common_flags, device_of, policy_of

CKPT_EVERY, LOG_EVERY = 50, 10


def lm_100m():
    """~100M-param llama-family config (the reference's, field for
    field)."""
    from repro_torch.configs import get

    return replace(
        get("llama3_2_1b"),
        num_layers=10, d_model=640, num_heads=10, num_kv_heads=5,
        head_dim=64, d_ff=2560, vocab_size=50304, remat=False)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_lm"))
    add_common_flags(ap)
    return ap


def build_loop(args, cfg, dev, params=None, ckpt_every: int = CKPT_EVERY):
    """The ``TrainLoop`` ``main`` runs for ``cfg`` under ``--policy``:
    ``params`` (default ``init_params(0, cfg)``), AdamW, the train step
    with ``--accum`` microbatches and the token stream, checkpoints in
    ``--ckpt-dir`` every ``ckpt_every`` steps."""
    from repro_torch.data import DataConfig, device_transform, make_stream
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import (LoopConfig, TrainConfig, TrainLoop,
                                   make_train_step)

    cfg = replace(cfg, policy=policy_of(args))
    if params is None:
        params = M.init_params(0, cfg, device=dev)
    params = {k: v.to(dev) for k, v in params.items()}
    ocfg = OptConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps)
    tcfg = TrainConfig(opt=ocfg, accum_steps=args.accum)
    opt_state = adamw_init(params, ocfg)
    step = make_train_step(cfg, tcfg)
    stream = make_stream(DataConfig(batch=args.batch, seq_len=args.seq_len,
                                    vocab_size=cfg.vocab_size, seed=0))
    return TrainLoop(
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=ckpt_every, log_every=LOG_EVERY),
        step, stream, params, opt_state,
        batch_transform=device_transform(dev))


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device_of(args)
    cfg = lm_100m()
    loop = build_loop(args, cfg, dev)
    n = sum(p.numel() for p in loop.params.values())
    print(f"[train_lm] params={n/1e6:.1f}M layers={cfg.num_layers} "
          f"d={cfg.d_model} vocab={cfg.vocab_size}")
    resumed = loop.try_restore()
    if resumed:
        print(f"[train_lm] resumed at step {loop.state.step}")
    st = loop.run()
    if st.history:
        print(f"[train_lm] loss {st.history[0][1]:.4f} -> "
              f"{st.history[-1][1]:.4f} | stragglers={st.straggler_count} "
              f"nan_skips={st.nan_skip_count}")
    return {"params": n, "history": list(st.history), "resumed": resumed,
            "step": st.step, "stragglers": st.straggler_count,
            "nan_skips": st.nan_skip_count,
            "ema_step_s": st.ema_step_time}


if __name__ == "__main__":
    main()
