"""Serving launcher, the port of ``repro.launch.serve``: batched generation
for an LM, or the continuous-batching scheduler for an LM or M³ViT, on the
card unless ``--device cpu`` is given.

Usage:
  python -m repro_torch.launch.serve --arch llama3_2_1b --smoke --tokens 32
  # continuous-batching scheduler over a mixed-task workload:
  python -m repro_torch.launch.serve --arch kimi_k2_1t_a32b --smoke \\
      --scheduler --requests 16 --tasks 2 --device cpu
  # the paper's M3ViT (semseg + depth) through the same scheduler with
  # paged expert weights:
  python -m repro_torch.launch.serve --arch m3vit --scheduler \\
      --resident-fraction 0.5 --async-paging
  # SLO-aware serving: tiered admission, preemption (KV park/restore),
  # chunked-prefill interleave, driven by a bursty multi-tenant trace,
  # with a shared prompt-prefix cache:
  python -m repro_torch.launch.serve --arch llama3_2_1b --scheduler \\
      --slo --trace bursty --prefix-cache 16 --prefill-chunk 64
  # packed weights: int8 (or int4) QTensor weights and an int8 KV cache;
  # M3ViT's experts factored into a shared basis + rank-8 deltas:
  python -m repro_torch.launch.serve --arch llama3_2_1b --quant int8
  python -m repro_torch.launch.serve --arch m3vit --scheduler \\
      --factor rank:8 --resident-fraction 0.5
  # the recurrent families (recurrent state through engine and scheduler;
  # no prefix cache, no chunked admission, unpadded prompts):
  python -m repro_torch.launch.serve --arch xlstm_350m --scheduler \\
      --batch 8 --requests 16 --max-len 512
  python -m repro_torch.launch.serve --arch recurrentgemma_9b --batch 8 \\
      --prompt-len 128 --tokens 32 --max-len 512
  # stub frontends (MusicGen's EnCodec frames, Qwen2-VL's patches): seeded
  # (requests, prompt_len, d) embedding prompts, tokens fed back as rows
  # of the pseudo-embedding table:
  python -m repro_torch.launch.serve --arch musicgen_large --scheduler \\
      --batch 8 --requests 16 --prompt-len 128 --max-len 512
  # M3ViT-many (256 experts, 8 tasks) with factored, paged experts:
  python -m repro_torch.launch.serve --arch m3vit_many --smoke --scheduler \\
      --factor rank:8 --expert-budget-bytes 2000000
  # mesh serving ("DxM" = data x model: decode state and prompts sharded
  # over data, M3ViT's experts paged expert-parallel over model), one
  # process a rank: NCCL on the cards, gloo with --device cpu
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch m3vit --scheduler --mesh 1x4
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch llama3_2_1b --smoke --mesh 2x2 --device cpu

``--arch`` takes every name of ``configs.ARCH_NAMES`` and ``m3vit_many``.

Without ``--policy`` an LM serves under ``cuda`` with
``attention_decode="cuda_fused"`` (the decode kernel reads each slot's own
cache length on the card; ``cuda``'s decode impl takes uniform lengths
only and raises on the card when the scheduler mixes positions), and
M³ViT under ``cuda``.  ``--quant int8|int4`` quantizes the weight tree
(QTensor leaves) and stores the KV cache int8; without ``--policy`` it
overrides ``linear``, ``moe_grouped_gemm`` and ``attention_decode`` to
``eager_int8``, so the packed ops are dispatch hits while attention and
the activations stay on the kernels.  ``--factor rank:R|butterfly``
factors M³ViT's experts per MoE layer (deltas at ``--quant``'s precision,
the basis float32) and overrides ``moe_grouped_gemm`` to
``eager_factored``.  ``--policy eager_int8`` / ``eager_factored`` give the
reference's presets.  On the card an LM's random weights are drawn there
(``model.init_params(..., draw_on_device=True)``: RecurrentGemma-9B's
9.6 B parameters would take minutes of NumPy on the host); on the CPU by
NumPy.

``--mesh DxM`` serves over a ``DeviceMesh`` of D × M ranks with the
sharding rules (``fsdp=False``, as the reference's launcher): run it
under ``torchrun`` with D·M processes (NCCL, one card a rank), or with
``--device cpu`` (gloo, the counterpart of the reference's forced host
devices).  Without ``torchrun`` the world is one process, so only
``--mesh 1x1`` runs; a mesh whose D·M is not the world size raises,
naming both.  Rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace

import numpy as np

POLICIES = ("eager", "blocked", "cuda", "cuda_fused", "ref", "eager_int8",
            "eager_factored")
INT8_OPS = ("linear", "moe_grouped_gemm", "attention_decode")


def _policy(args, vision: bool):
    from repro_torch.ops import policy_named

    if args.policy is not None:
        policy = policy_named(args.policy)
    else:
        policy = policy_named("cuda")
        if not vision:
            policy = policy.with_impls(attention_decode="cuda_fused")
        if args.quant:
            # the packed ops on their impls; attention and the activations
            # stay on the kernels
            policy = policy.with_impls(**{op: "eager_int8"
                                          for op in INT8_OPS})
    if args.factor:
        policy = policy.with_impls(moe_grouped_gemm="eager_factored")
    return policy


def _parse_factor(spec: str) -> tuple[str, int]:
    """``rank:R`` -> ("rank", R); ``butterfly`` -> ("butterfly", 0)."""
    s = spec.lower()
    if s == "butterfly":
        return "butterfly", 0
    if s.startswith("rank:"):
        try:
            r = int(s.split(":", 1)[1])
        except ValueError:
            raise SystemExit(f"--factor rank:R needs an integer R, "
                             f"got {spec!r}")
        if r < 0:
            raise SystemExit(f"--factor rank must be >= 0, got {r}")
        return "rank", r
    raise SystemExit(f"--factor expects rank:R or butterfly, got {spec!r}")


def factor_spec(args):
    """``--factor``/``--quant`` -> the ``(kind, rank, delta_bits)`` triple
    (deltas at ``--quant``'s precision; the basis stays float32)."""
    kind, rank = _parse_factor(args.factor)
    return kind, rank, {"int8": 8, "int4": 4}.get(args.quant)


def _quantize(params, args):
    from repro_torch.quant import quantize_tree, tree_bytes

    before = tree_bytes(params)
    params = quantize_tree(params, bits=8 if args.quant == "int8" else 4)
    print(f"[serve] --quant {args.quant}: weights {before / 1e6:.2f} MB -> "
          f"{tree_bytes(params) / 1e6:.2f} MB")
    return params


def _parse_mesh(spec: str) -> tuple[int, int]:
    try:
        d, m = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh expects DxM (e.g. 2x4), got {spec!r}")
    if d < 1 or m < 1:
        raise SystemExit(f"--mesh axes must be >= 1, got {spec!r}")
    return d, m


def mesh_rules(spec: str, dev):
    """The sharding rules of ``--mesh DxM`` over the default process group
    (started here from ``torchrun``'s environment, or as a world of one
    with an in-memory store); returns (rules, device of this rank, whether
    this call started the group)."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.dist.spmd import init_mesh

    d, m = _parse_mesh(spec)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if d * m != world:
        raise ValueError(f"--mesh {spec} holds {d * m} ranks but the world "
                         f"size is {world} (start {d * m} processes with "
                         f"torchrun --nproc-per-node {d * m})")
    started = not dist.is_initialized()
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if started:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if world == 1 and "MASTER_ADDR" not in os.environ:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0)
        else:
            dist.init_process_group(backend)
    mesh = init_mesh((d, m), device_type=dev.type)
    return ShardingRules.for_mesh(mesh, fsdp=False), dev, started


def _pct(m, key):
    return f"{m[key] * 1e3:.1f}ms"


def host_syncs(sched) -> tuple[int, float]:
    """(decode steps, host syncs per decode step) over an LM scheduler's
    buckets, the admissions' own reads left out."""
    steps = syncs = 0
    for b in sched.buckets.values():
        steps += b.steps
        syncs += b.host_syncs - b.admissions
    return steps, syncs / steps if steps else 0.0


def _prompts(rng, cfg, n: int, length: int) -> np.ndarray:
    """``n`` prompts from ``rng``: int32 token ids, or (length, d) float32
    embeddings for a stub frontend."""
    if cfg.embed_input == "tokens":
        return rng.integers(0, cfg.vocab_size, (n, length)).astype(np.int32)
    return rng.standard_normal((n, length, cfg.d_model)).astype(np.float32)


def serve_scheduler_lm(cfg, params, scfg, args, dev, rules=None) -> dict:
    from repro_torch.serve import LMBackend, Request, Scheduler
    from repro_torch.serve.slo import SLOPolicy, TraceConfig, TraceGenerator

    backend = LMBackend(cfg, params, scfg, rules=rules, device=dev)
    num_tasks = max(args.tasks, 1)
    if cfg.moe is not None:      # the gate table bounds the task-id space
        num_tasks = min(num_tasks, backend.num_tasks)
    else:
        num_tasks = 1
    slo = SLOPolicy() if args.slo else None
    sched = Scheduler(backend, total_slots=args.batch, quantum=4,
                      num_tasks=num_tasks, slo=slo)
    if args.trace:
        if cfg.embed_input != "tokens":
            raise SystemExit("--trace generates token prompts; "
                             f"arch {cfg.name} embeds raw inputs")
        tc = TraceConfig(
            n=args.requests, seed=args.seed, vocab=cfg.vocab_size,
            num_tasks=num_tasks,
            burst_factor=8.0 if args.trace == "bursty" else 1.0,
            shared_prefix_len=16 if scfg.prefix_cache > 0 else 0)
        reqs = TraceGenerator(tc).generate()
    else:
        rng = np.random.default_rng(args.seed)
        prompts = _prompts(rng, cfg, args.requests, args.prompt_len)
        lengths = rng.integers(max(args.tokens // 4, 1), args.tokens + 1,
                               args.requests)
        reqs = [Request(rid=i, task_id=i % num_tasks, prompt=prompts[i],
                        max_new_tokens=int(lengths[i]))
                for i in range(args.requests)]
    done = sched.run(reqs)
    m = sched.metrics()
    tpot = [r.tpot for r in done if np.isfinite(r.tpot)]
    steps, per_step = host_syncs(sched)
    print(f"[serve] arch={cfg.name} scheduler served {len(done)} requests "
          f"({m['tokens']} tokens) over {num_tasks} task(s) on {dev}: "
          f"{m['tok_per_s']:.1f} tok/s, ttft p50 {_pct(m, 'ttft_p50_s')} "
          f"p99 {_pct(m, 'ttft_p99_s')}, tpot p50 "
          f"{np.percentile(tpot, 50) * 1e3 if tpot else 0.0:.1f}ms p99 "
          f"{np.percentile(tpot, 99) * 1e3 if tpot else 0.0:.1f}ms, "
          f"latency p50 {_pct(m, 'latency_p50_s')} p99 "
          f"{_pct(m, 'latency_p99_s')}, slot util "
          f"{m.get('slot_utilization', 0):.2f}; {steps} decode steps, "
          f"{per_step:.2f} host syncs a step")
    for name, tm in sorted(m.get("tiers", {}).items()):
        if slo is None and not args.trace:
            break
        print(f"[serve]   tier {name}: {tm['requests']} reqs, "
              f"ttft p50 {_pct(tm, 'ttft_p50_s')} / "
              f"p99 {_pct(tm, 'ttft_p99_s')}, "
              f"slo_attainment {tm['slo_attainment']:.2f}, "
              f"preemptions {tm['preemptions']}")
    if slo is not None:
        print(f"[serve] slo: goodput {m['goodput_rps']:.1f} req/s "
              f"({m['goodput_tok_per_s']:.1f} tok/s), "
              f"preemptions {m['preemptions']}, restores {m['restores']}, "
              f"parked peak {m['parked_bytes_peak'] / 1e6:.2f} MB")
    if "prefix_cache" in m:
        pc = m["prefix_cache"]
        print(f"[serve] prefix cache: {pc['entries']} entries, "
              f"hit_rate {pc['hit_rate']:.2f}, "
              f"{pc['hit_tokens']} prefill tokens skipped")
    return m


def serve_scheduler_vision(cfg, args, dev, rules=None) -> dict:
    from repro_torch.configs import m3vit as MV
    from repro_torch.models import vit as V
    from repro_torch.serve import Request, Scheduler, VisionBackend

    params = V.init_params(args.seed, cfg, device=dev)
    if args.quant:
        params = _quantize(params, args)
    # factorization happens per MoE layer inside the server, after the
    # per-layer slice; quantized expert leaves re-factor there too
    backend = VisionBackend(cfg, params,
                            resident_fraction=args.resident_fraction,
                            expert_budget_bytes=args.expert_budget_bytes
                            or None,
                            async_paging=args.async_paging,
                            factor=factor_spec(args) if args.factor
                            else None,
                            placement=args.placement, rules=rules,
                            device=dev)
    sched = Scheduler(backend, total_slots=args.batch, quantum=1,
                      num_tasks=len(MV.TASKS))
    imgs = np.random.default_rng(args.seed).normal(
        size=(4, MV.IMAGE_H, MV.IMAGE_W, 3)).astype(np.float32)
    reqs = [Request(rid=i, task_id=i % len(MV.TASKS),
                    prompt=imgs[i % imgs.shape[0]])
            for i in range(args.requests)]
    done = sched.run(reqs)
    m = sched.metrics()
    cache = m.get("expert_cache", {})
    if "shard_load" in m:
        print(f"[serve] shard load {m['shard_load']}, imbalance "
              f"{m['shard_load_imbalance']:.3f}")
    print(f"[serve] arch={cfg.name} scheduler served {len(done)} "
          f"semseg/depth requests on {dev}: {m['items_per_s']:.1f} img/s, "
          f"latency p50 {_pct(m, 'latency_p50_s')} p99 "
          f"{_pct(m, 'latency_p99_s')}; expert cache: hit_rate "
          f"{cache.get('hit_rate', 1.0):.2f} at resident_fraction "
          f"{cache.get('resident_fraction', 1.0):.2f}")
    if args.async_paging:
        print(f"[serve] async paging: "
              f"stall {cache.get('stall_s', 0.0) * 1e3:.1f}ms, "
              f"hidden {cache.get('hidden_s', 0.0) * 1e3:.1f}ms, "
              f"overlap_ratio {cache.get('overlap_ratio', 1.0):.2f}")
    return m


def serve_static(cfg, params, scfg, args, dev, rules=None):
    from repro_torch.serve import ServingEngine

    engine = ServingEngine(cfg, params, scfg, rules=rules, device=dev)
    prompts = _prompts(np.random.default_rng(args.seed), cfg, args.batch,
                       args.prompt_len)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.tokens, task_id=args.task_id)
    dt = time.perf_counter() - t0
    print(f"[serve] arch={cfg.name} generated {out.shape} on {dev} in "
          f"{dt:.2f}s ({args.batch * args.tokens / dt:.1f} tok/s)")
    print(out[: min(2, out.shape[0])])
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where to serve (default: the card; 'cpu' runs "
                         "every kernel module's plain version)")
    ap.add_argument("--batch", type=int, default=4,
                    help="static batch, or the scheduler's total slots")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--task-id", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill size (0 = one-shot)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop a sequence at this token (-1 = never)")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve a workload through the continuous-batching "
                         "scheduler")
    ap.add_argument("--requests", type=int, default=16,
                    help="scheduler mode: number of requests")
    ap.add_argument("--tasks", type=int, default=2,
                    help="scheduler mode: number of gating tasks")
    ap.add_argument("--slo", action="store_true",
                    help="scheduler mode: SLO-aware tiered admission, "
                         "batch-slot preemption with KV park/restore, "
                         "chunked-prefill interleave")
    ap.add_argument("--trace", default=None, choices=["bursty", "steady"],
                    help="scheduler mode: arrivals from a seeded "
                         "multi-tenant traffic trace")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="scheduler mode: cache up to N prompt prefill "
                         "states in a radix trie")
    ap.add_argument("--resident-fraction", type=float, default=0.5,
                    help="vision scheduler: fraction of experts resident")
    ap.add_argument("--expert-budget-bytes", type=int, default=0,
                    help="vision scheduler: per-layer expert-weight byte "
                         "budget (0 = use --resident-fraction)")
    ap.add_argument("--async-paging", action="store_true",
                    help="vision scheduler: page expert weights through "
                         "the copy-stream TransferEngine")
    ap.add_argument("--placement", default=None,
                    choices=["static", "lru", "budget", "elastic"],
                    help="vision scheduler: expert placement policy")
    ap.add_argument("--policy", default=None, choices=POLICIES,
                    help="compute policy for every serving step")
    ap.add_argument("--dispatch-report", action="store_true",
                    help="print ops.dispatch_report() after serving")
    ap.add_argument("--quant", default=None, choices=["int8", "int4"],
                    help="quantize the weight tree (QTensor leaves), store "
                         "the KV cache int8, and serve linear, "
                         "moe_grouped_gemm and attention_decode on "
                         "eager_int8 unless --policy is given")
    ap.add_argument("--factor", default=None, metavar="KIND",
                    help="factor each MoE layer's expert weights into a "
                         "shared basis + per-expert delta ('rank:R' or "
                         "'butterfly'), serve moe_grouped_gemm on "
                         "eager_factored; the paged cache pins the basis "
                         "and pages only the deltas.  With --quant the "
                         "deltas quantize at its precision")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve over a data x model mesh of D*M ranks "
                         "(torchrun; gloo with --device cpu)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from repro_torch import resolve_device

    dev = resolve_device(args.device)
    rules, started = None, False
    if args.mesh:
        import contextlib
        import os

        import torch.distributed as dist

        rules, dev, started = mesh_rules(args.mesh, dev)
        quiet = contextlib.ExitStack()
        if dist.get_rank() != 0:
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        print(f"[serve] mesh {args.mesh} (data x model) over "
              f"{dist.get_world_size()} rank(s), {dist.get_backend()}")
    try:
        _serve(args, dev, rules)
    finally:
        if args.mesh:
            quiet.close()
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


def _serve(args, dev, rules) -> None:
    from repro_torch.configs import get
    from repro_torch.models import model as M
    from repro_torch.ops import dispatch_report
    from repro_torch.serve import ServeConfig

    if dev.type == "cuda":
        from repro_torch.kernels import build

        # the kernels build at first use: do it before the serving clock
        print(f"[serve] kernels built and loaded in "
              f"{build.build_seconds():.1f} s")
    cfg = get(args.arch, smoke=args.smoke)
    vision = cfg.family == "vit-moe"
    policy = _policy(args, vision)
    if vision:
        if not args.scheduler:
            raise SystemExit("M3ViT serves through --scheduler")
        serve_scheduler_vision(replace(cfg, policy=policy), args, dev,
                               rules)
    else:
        scfg = ServeConfig(max_len=args.max_len,
                           temperature=args.temperature, eos_id=args.eos_id,
                           seed=args.seed, prefill_chunk=args.prefill_chunk,
                           policy=policy, prefix_cache=args.prefix_cache,
                           kv_quant="int8" if args.quant else None)
        params = M.init_params(args.seed, cfg, device=dev,
                               draw_on_device=dev.type == "cuda")
        if args.factor:
            from repro_torch.factor import factorize_tree

            # stacked expert leaves beside their router only: scanned
            # layer stacks (ndim 4) pass through
            kind, rank, bits = factor_spec(args)
            params = factorize_tree(params, kind=kind, rank=rank,
                                    delta_bits=bits)
        if args.quant:
            params = _quantize(params, args)
        if args.scheduler:
            if scfg.temperature > 0:
                scfg = replace(scfg, temperature=0.0)
                print("[serve] the scheduler decodes greedily; ignoring "
                      "temperature")
            serve_scheduler_lm(cfg, params, scfg, args, dev, rules)
        else:
            serve_static(cfg, params, scfg, args, dev, rules)
    if args.dispatch_report:
        print("[serve] dispatch report:", json.dumps(dispatch_report()))
        if rules is not None:
            from repro_torch.ops import collective_report

            print("[serve] collectives:", json.dumps(collective_report()))


if __name__ == "__main__":
    raise SystemExit(main())
