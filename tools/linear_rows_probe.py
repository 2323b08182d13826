#!/usr/bin/env python3
"""Does a row's output depend on how many rows share its call?  On the card,
for the tree whose root is given (this checkout by default):

    python3 tools/linear_rows_probe.py [ROOT] [--lm] [--tiles]

* ``unified_linear`` at every Llama-3.2-1B and M³ViT projection shape: the
  rows of launches of M = 1 … 1024 rows against the M = 1024 launch (the
  count of differing outputs and their largest difference), and the device
  time of one launch at M = 8 and M = 1024 (``chip_smoke.time_ms``: a CUDA
  graph of 10 calls replayed 20 times).  ``ROOT`` may be another commit's
  tree (e.g. ``git archive`` unpacked under the git-ignored ``build/``):
  its own ``src`` is imported and its kernels built there.
* ``--lm``: the RMSNorm row mean and the float32 tied LM head at 1..16
  rows (the port's padded forms beside plain ``torch.mean`` /
  ``torch.matmul``), and a 2-layer full-width Llama-3.2-1B whose tokens
  and prefill logits, served alone, in a batch of 8 and padded to a
  multiple of 16, must agree.
* ``--tiles``: Llama's folded gate/up and down projections at M = 1024
  timed at 64- and 128-token tiles (the planner's plan with its tile
  replaced), each checked bit-identical to the planner's own launch.

Prints the card's name and power limit first and one JSON line last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ROOT = Path(ARGS[0] if ARGS else Path(__file__).resolve().parents[1])
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import repro_torch  # noqa: E402,F401  (ROOT's package, before chip_smoke's)
import torch  # noqa: E402

from chip_smoke import randn, time_ms  # noqa: E402

SHAPES = {"m3vit_patch_embed": (768, 192), "m3vit_qkvo": (192, 192),
          "m3vit_mlp_up": (192, 768), "m3vit_mlp_down": (768, 192),
          "m3vit_semseg_head": (192, 4864), "m3vit_depth_head": (192, 256),
          "lm_q_o": (2048, 2048), "lm_k_v": (2048, 512),
          "lm_gate_up": (2048, 8192), "lm_down": (8192, 2048)}
MS = (1, 8, 16, 64, 70, 72, 80, 128, 1024)


def linear_rows(kul) -> dict:
    out = {}
    for i, (name, (k, n)) in enumerate(SHAPES.items()):
        x = randn((1024, k), torch.bfloat16, seed=10 + i)
        w = randn((k, n), torch.bfloat16, k ** -0.5, seed=20 + i)
        full = kul.unified_linear(x, w)
        rows = {}
        for m in MS:
            d = (kul.unified_linear(x[:m].contiguous(), w).float()
                 - full[:m].float()).abs()
            rows[m] = [int((d != 0).sum()), float(d.max())]
        ms = {m: time_ms(lambda m=m: kul.unified_linear(x[:m], w))
              for m in (8, 1024)}
        out[name] = {"rows_differing_vs_m1024": rows, "ms": ms}
        print(name, json.dumps(out[name]), flush=True)
    return out


def lm_rows() -> dict:
    from repro_torch import ops
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.models import layers as L
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    cfg, res = LL.CONFIG, {}
    x = randn((1024, 2048), torch.float32, seed=3)
    for label, mean in (("padded", L._row_mean),
                        ("torch.mean", lambda v: v.mean(-1, keepdim=True))):
        full = mean(x * x)
        res[f"rms_mean_{label}"] = {
            m: int((mean(x[:m] * x[:m]) != full[:m]).sum())
            for m in (1, 2, 4, 8, 16, 70, 128)}
    table = randn((cfg.vocab_size, 2048), torch.bfloat16, 0.02, seed=4)
    xs = randn((16, 2048), torch.bfloat16, seed=5)
    full = L.apply_lm_head({}, {"tokens": table}, xs, cfg)
    res["head_padded"] = {
        m: int((L.apply_lm_head({}, {"tokens": table}, xs[:m], cfg)
                != full[:m]).sum()) for m in (1, 2, 8, 9)}
    plain = torch.matmul(xs.float(), table[:16384].float().T)
    res["head_torch.matmul_1_vs_16_rows"] = int(
        (torch.matmul(xs[:1].float(), table[:16384].float().T)
         != plain[:1]).sum())
    print(json.dumps(res), flush=True)
    policy = ops.policy_named("cuda").with_impls(attention_decode="cuda_fused")
    cfg2 = replace(cfg, num_layers=2)
    eng = ServingEngine(cfg2, LM.init_params(0, cfg2),
                        ServeConfig(max_len=512, policy=policy))
    rng = np.random.default_rng(0)
    prefill, _ = eng.steps()
    for s0 in (16, 70, 128):
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                (8, s0))).cuda()
        batch = eng.generate(prompts, 8)
        alone = np.concatenate([eng.generate(prompts[i:i + 1], 8)
                                for i in range(8)])
        copies = eng.generate(prompts[:1].expand(8, -1).contiguous(), 8)
        with torch.inference_mode():
            lb, _ = prefill(eng.params, prompts, LM.init_state(cfg2, 8, 512))
            l1, _ = prefill(eng.params, prompts[:1],
                            LM.init_state(cfg2, 1, 512))
            padded = torch.cat([prompts[:1], prompts.new_zeros(
                (1, -(-s0 // 16) * 16 - s0))], 1)
            lp, _, _ = LM.forward(eng.params, padded, eng.cfg,
                                  state=LM.init_state(cfg2, 1, 512),
                                  cache_index=0, return_state=True,
                                  logits_mode=s0 - 1)
        res[f"lm_2_layers_prompt_{s0}"] = {
            "tokens_alone_eq_batch": bool((alone == batch).all()),
            "tokens_copies_eq_alone": bool((copies == alone[:1]).all()),
            "prefill_logits_b1_vs_b8_differing": int((l1[0] != lb[0]).sum()),
            "padded_prefill_logits_differing": int((lp[:, 0] != l1).sum())}
        print(s0, json.dumps(res[f"lm_2_layers_prompt_{s0}"]), flush=True)
    return res


def fold_tiles(kul, gp) -> dict:
    res, orig = {}, gp.plan_linear
    for name in ("lm_gate_up", "lm_down"):
        k, n = SHAPES[name]
        x = randn((1024, k), torch.bfloat16, seed=1)
        w = randn((k, n), torch.bfloat16, k ** -0.5, seed=2)
        base = orig(1024, n, k, torch.bfloat16, 132)
        want = kul.unified_linear(x, w)
        for bt, nwg in ((64, 2), (128, 2)):
            plan = replace(base, bt=bt, nwg=nwg, stages=gp._stages(
                bt, nwg, -(-k // 64)), grid=(-(-n // (64 * nwg)),
                                             -(-1024 // bt), 1))
            gp.plan_linear = lambda *a, **kw: plan
            try:
                same = bool(torch.equal(kul.unified_linear(x, w), want))
                t = time_ms(lambda: kul.unified_linear(x, w))
            finally:
                gp.plan_linear = orig
            res[f"{name}_{64 * nwg}x{bt}"] = {"fold": base.fold,
                                              "bit_equal": same, "ms": t}
            print(name, bt, nwg, json.dumps(res[f"{name}_{64 * nwg}x{bt}"]),
                  flush=True)
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("linear_rows_probe: needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch.kernels import gemm_plan as gp
    from repro_torch.kernels import unified_linear as kul

    t0 = time.perf_counter()
    out = {"root": str(ROOT), "linear": linear_rows(kul)}
    if "--lm" in sys.argv:
        out["lm"] = lm_rows()
    if "--tiles" in sys.argv:
        out["tiles"] = fold_tiles(kul, gp)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
