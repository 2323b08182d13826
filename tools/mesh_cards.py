#!/usr/bin/env python3
"""Mesh serving across cards, one process a card under ``torchrun`` (NCCL):
each rank runs the mesh path and the same work with no mesh on its own
card, and holds the two against each other.

    python3 -c "from repro_torch.kernels import build; build.build_seconds()"
    torchrun --standalone --nproc-per-node 4 tools/mesh_cards.py --mesh 1x4
    torchrun --standalone --nproc-per-node 4 tools/mesh_cards.py --mesh 2x2
    torchrun ... tools/mesh_cards.py --mesh 1x4 --only recurrentgemma
    torchrun ... tools/mesh_cards.py --mesh 1x4 --only xlstm
    torchrun --standalone --nproc-per-node 4 tools/mesh_cards.py \
        --mesh 2x2 --fsdp

(build once before ``torchrun``: the ranks then load the same library
instead of compiling it side by side).  ``--device cpu`` runs the same
over gloo with the kernels' plain versions, at the models' smoke sizes
(a rehearsal).  Under a ``model`` axis larger than one the dense blocks
run tensor-parallel (``models/layers.py``), whose row-parallel sums run
in another order than one card's: those checks hold the logits of the
prefill and of teacher-forced decode steps at cosine >= ``SERVE_COSINE``
(``kernels/compare.py``) and report the share of greedy tokens equal to
no mesh's; where ``model`` has one rank they stay bit for bit.  Checks,
at full width, bf16, seeded:

* M³ViT ``M3ViTServer(rules=)`` paged through ``ShardedExpertCache`` at
  resident fraction 0.5, batch 8, both tasks, against the unmeshed
  all-resident server (its MLPs split over ``model``, its three heads
  whole);
* ``apply_moe_ep_local`` on an M³ViT MoE layer (16 experts over
  ``model``) against ``grouped``: within the bf16 tolerance of
  ``kernels/compare.py``;
* Llama-3.2-1B ``ServingEngine(rules=)``, 8 × 128 prompts, 32 greedy
  tokens, against the unmeshed engine;
* Llama-4-Scout at full width, 2 of its 48 layers, the same: its
  4096-token routing groups span the data ranks, so every rank routes
  the whole batch from the gathered router logits;
* RecurrentGemma-9B at full width and depth, the same: its RG-LRU
  mixers split over ``model`` with the MLPs, q heads and vocabulary (its
  one KV head whole), the weight bytes, RG-LRU bytes and decode-state
  bytes a rank beside the whole;
* xLSTM-350M at full width and depth, the same: its mLSTM and sLSTM
  heads split over ``model`` (one of 4 a rank at 1x4) with the
  vocabulary, the mixer weight bytes and decode-state bytes a rank
  beside the whole; where bf16 noise alone puts the logits below
  ``SERVE_COSINE`` (xLSTM's stack amplifies roundings), the mesh and no
  mesh are held against the same model in float32
  (``serving_agrees``);
* DeepSeek-67B at 16 of its 95 layers, each rank's blocks drawn on its
  card (``init_params(rules=)``), against one card's 16-layer run from
  the same seed (``serving_agrees``);
* DeepSeek-67B at all 95 layers, which one card cannot hold (125.6 GiB
  in bf16): 8 × 128 prompts, 32 greedy tokens, ``max_len`` 512 — the
  same tokens on every rank, finite logits, prefill ms, ms a decode step,
  tokens/s, peak GiB a rank, launches by kernel, the collectives' count,
  bytes and device ms (``train/profile.py:profile_steps``).

``--fsdp`` runs instead FSDP of serving's weights
(``serve.engine.place_params``: every leaf at its block over data and
model, each layer's leaves gathered just before the layer runs) on
DeepSeek-67B at all 95 layers, each rank drawing its blocks on its card,
8 × 128 prompts and 32 greedy tokens: over ``--mesh`` under the default
``fsdp=True`` against the same mesh under ``fsdp=False``, tokens bit for
bit (at 2x2 ``fsdp=False``'s 62.8 GiB a rank fit an 80 GB card); then
over (world, 1) under
``fsdp=True`` — the same tokens on every rank — held against the
tensor-parallel (1, world) run under ``fsdp=False`` by
``compare.serving_agrees`` on the prefill's and ``FORCED`` teacher-forced
steps' logits.  Each run reports its weights GiB and peak GiB a rank
against the table's blocks, prefill ms, ms a decode step, tokens/s, and
the collectives' count, bytes and device ms.

Rank 0 prints the card's name and power limit, each check's result, the
launches by kernel of each mesh run, the collectives, and the host walls
(median of 3) with and without the mesh.  Any failed check raises.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist


SCOUT_LAYERS = 2        # Llama-4-Scout's depth here, at full width
DEEPSEEK_CUT = 16       # DeepSeek-67B's depth held against one card
FORCED = 8              # teacher-forced decode steps a logits check reads
#: the checks, in the order they run (``--only`` picks some)
CHECKS = ("m3vit", "llama", "scout", "recurrentgemma", "xlstm",
          "deepseek")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _wall_ms(run, reps=3) -> float:
    walls = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        run()
        _sync()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


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
        key = f"{c['kind']}:{c['axis']}"
        coll[key] = coll.get(key, 0) + c["count"]
    return out, launch_counts(), coll


def _forced(engine, rules, prompts, toks, steps: int) -> list:
    """float32 logits of the prefill and of ``steps`` decode steps fed
    ``toks`` (teacher-forced: the same inputs with and without a mesh)."""
    from repro_torch.dist.sharding import use_rules

    prefill, decode = engine.steps(0)
    out = []
    with torch.inference_mode(), use_rules(rules):
        state = engine.new_state(prompts.shape[0])
        logits, state = prefill(engine.params, prompts, state)
        out.append(logits.float())
        for i in range(steps):
            tok = torch.as_tensor(toks[:, i:i + 1],
                                  device=engine.device).long()
            logits, state = decode(engine.params, tok, state,
                                   prompts.shape[1] + i)
            out.append(logits.float())
    return out


def _float32_logits(cfg, params, scfg, prompts, toks, device) -> list:
    """The same model in float32 (weights widened, the plain ``eager``
    policy), teacher-forced on ``toks``: ``_forced``'s logits."""
    from repro_torch import ops
    from repro_torch.serve.engine import ServingEngine

    cfg32 = replace(cfg, dtype="float32", policy=ops.policy_named("eager"))
    engine = ServingEngine(cfg32, {k: v.float() for k, v in params.items()},
                           replace(scfg, policy=cfg32.policy), device=device)
    return _forced(engine, None, prompts, toks, FORCED)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", required=True, metavar="DxM")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", default=None, metavar="NAME[,NAME]",
                    help=f"run only these checks, of {', '.join(CHECKS)} "
                         f"(default: all)")
    ap.add_argument("--fsdp", action="store_true",
                    help="run DeepSeek-67B with serving's weights FSDP "
                         "instead of the checks")
    args = ap.parse_args()
    smoke = args.device == "cpu"
    only = set(args.only.split(",")) if args.only else set(CHECKS)
    if only - set(CHECKS):
        raise SystemExit(f"--only: unknown {sorted(only - set(CHECKS))}")

    def on(name):
        return name in only

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import ops
    from repro_torch.configs import get
    from repro_torch.configs import llama3_2_1b as LL
    from repro_torch.dist import spmd
    from repro_torch.kernels.compare import (SERVE_COSINE, cosine,
                                             serving_agrees)
    from repro_torch.launch.serve import mesh_rules
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.tree import flatten

    rules, dev, _ = mesh_rules(args.mesh, torch.device(args.device))
    rank = dist.get_rank()
    tp = spmd.axis_size(rules.mesh, "model")

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    if not smoke:
        say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip())
    say(f"mesh {args.mesh} over {dist.get_world_size()} ranks, "
        f"{dist.get_backend()}; torch {torch.__version__}; the dense blocks "
        f"{'tensor-parallel over ' + str(tp) if tp > 1 else 'whole'}")
    policy = ops.policy_named("cuda")

    def agree(label, got, want, mesh_engine, plain_logits, prompts,
              f32_logits=None):
        """Tokens bit-equal where model has one rank; else the
        teacher-forced logits at SERVE_COSINE — or, where ``f32_logits``
        (the same model's float32 logits, a callable) is given and they
        fall below it, no further from float32 than no mesh's
        (``serving_agrees``) — and the share of equal tokens reported."""
        if tp == 1:
            same = np.array_equal(got, want)
            say(f"  {label}: tokens equal to no mesh {same}")
            if not same:
                raise AssertionError(f"rank {rank}: {label} tokens differ")
            return
        kern = _forced(mesh_engine, rules, prompts, want, FORCED)
        cos = [cosine(a, b) for a, b in zip(kern, plain_logits)]
        k32 = p32 = None
        if min(cos) < SERVE_COSINE and f32_logits is not None:
            ref = f32_logits()
            k32 = [cosine(a, b) for a, b in zip(kern, ref)]
            p32 = [cosine(a, b) for a, b in zip(plain_logits, ref)]
            say(f"  {label}: against the same model in float32, the mesh "
                f"at cosine {min(k32):.6f}, no mesh {min(p32):.6f} at "
                f"their worst")
        ok = serving_agrees(cos, k32, p32)
        say(f"  {label}: logits of the prefill and {FORCED} teacher-forced "
            f"steps at cosine {min(cos):.6f}..{max(cos):.6f} of no mesh "
            f"(>= {SERVE_COSINE}, or serving_agrees against float32: "
            f"{ok}); greedy tokens equal to no mesh's: "
            f"{float((got == want).mean()):.4f} of them")
        if not ok:
            raise AssertionError(f"rank {rank}: {label} logits {cos}")

    pol = policy.with_impls(attention_decode="cuda_fused")
    if args.fsdp:
        fsdp_deepseek(rules, dev, pol, smoke, say)
        dist.barrier()
        dist.destroy_process_group()
        say("MESH_CARDS_OK")
        return
    if on("m3vit"):
        m3vit(rules, dev, policy, smoke, say, tp)

    def engines(label, lcfg, scfg, draw, yardstick=None):
        """Serve 8 x 128 prompts, 32 greedy tokens, with and without the
        mesh (the whole draw for both), and hold them together (with
        ``yardstick``, e.g. ``_float32_logits``: against float32 where bf16
        noise alone exceeds SERVE_COSINE); the weight bytes a rank (its
        recurrent mixers' where it has them) and its decode state's at
        batch 8 beside the whole, and the collectives by ``where``."""
        lparams = LM.init_params(0, lcfg, device=dev, draw_on_device=draw)
        plain = ServingEngine(lcfg, lparams, scfg, device=dev)
        mesh = ServingEngine(lcfg, lparams, scfg, rules=rules, device=dev)

        def nbytes(tree, part=""):
            return sum(v.numel() * v.element_size() for k, v in tree.items()
                       if part in k)

        def mixer(tree):
            return sum(nbytes(tree, m) for m in (".rglru.", ".mlstm.",
                                                 ".slstm."))

        mixers = (f", recurrent mixers {mixer(mesh.params) / 2**20:.2f} "
                  f"of {mixer(lparams) / 2**20:.2f} MiB"
                  if mixer(lparams) else "")
        say(f"{label} a rank: weights {nbytes(mesh.params) / 2**30:.3f} of "
            f"{nbytes(lparams) / 2**30:.3f} GiB{mixers}, decode state at "
            f"batch 8 {nbytes(flatten(mesh.new_state(8))) / 2**20:.3f} of "
            f"{nbytes(flatten(plain.new_state(8))) / 2**20:.3f} MiB")
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, lcfg.vocab_size, size=(8, 128))).to(dev)
        want = plain.generate(prompts, 32)
        plain_logits = _forced(plain, None, prompts, want, FORCED)
        mesh.generate(prompts, 2)
        got, counts, coll = _counted(lambda: mesh.generate(prompts, 32))
        say(f"{label} 8 x 128 prompts, 32 greedy tokens: launches "
            f"{json.dumps(counts)}; collectives {json.dumps(coll)}")
        say("  collectives by where: " + json.dumps(
            {c["where"]: c["count"] for c in ops.collective_report()}))
        agree(label, got, want, mesh, plain_logits, prompts,
              None if yardstick is None else
              lambda: yardstick(lcfg, lparams, scfg, prompts, want, dev))
        say(f"  walls generate: "
            f"{_wall_ms(lambda: mesh.generate(prompts, 32)):.1f} ms with "
            f"the mesh, {_wall_ms(lambda: plain.generate(prompts, 32)):.1f}"
            f" ms without")
        del plain, mesh, lparams
        if not smoke:
            torch.cuda.empty_cache()

    if on("llama"):
        lcfg = LL.SMOKE_CONFIG if smoke else LL.CONFIG
        engines("Llama-3.2-1B", lcfg, ServeConfig(max_len=512, policy=pol),
                not smoke)

    # a MoE LM whose routing groups span the data ranks: a prefill's 1024
    # tokens and a decode step's 8 are one 4096-token group each, routed
    # whole on every rank from the gathered router logits
    # (core/moe.py:route_split); the staged expert layer by name, as
    # ``cuda`` names no moe_ffn impl
    if on("scout"):
        scout = get("llama4_scout_17b_a16e", smoke=smoke)
        if not smoke:
            scout = replace(scout, num_layers=SCOUT_LAYERS)
        engines(f"Llama-4-Scout ({scout.num_layers} layers)", scout,
                ServeConfig(max_len=512,
                            policy=pol.with_impls(moe_ffn="eager")),
                not smoke)
    # the hybrid at full depth: its RG-LRU mixers, MLPs, q heads and
    # vocabulary split over model, its one KV head whole
    if on("recurrentgemma"):
        engines("RecurrentGemma-9B",
                get("recurrentgemma_9b", smoke=smoke),
                ServeConfig(max_len=512, policy=pol), not smoke)
    # the attention-free recurrent LM at full depth: its mLSTM and sLSTM
    # heads (where model divides its 4) and vocabulary split
    if on("xlstm"):
        engines("xLSTM-350M", get("xlstm_350m", smoke=smoke),
                ServeConfig(max_len=512, policy=policy), not smoke,
                yardstick=_float32_logits)
    if on("deepseek"):
        deepseek(rules, dev, pol, smoke, say, agree)
    dist.barrier()
    dist.destroy_process_group()
    say("MESH_CARDS_OK")


def m3vit(rules, dev, policy, smoke, say, tp) -> None:
    """M³ViT paged and expert-parallel against no mesh, and
    ``apply_moe_ep_local`` against ``grouped``."""
    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.core import moe as moe_lib
    from repro_torch.dist.sharding import use_rules
    from repro_torch.kernels.compare import (SERVE_COSINE, cosine,
                                             max_abs_err, within_tolerance)
    from repro_torch.models.vit import init_params
    from repro_torch.serve.vision import M3ViTServer

    rank = dist.get_rank()
    cfg = replace(MV.SMOKE_CONFIG if smoke else MV.CONFIG, policy=policy)
    params = init_params(0, cfg, device=dev)
    imgs = np.random.default_rng(0).normal(
        size=(8, MV.IMAGE_H, MV.IMAGE_W, 3)).astype(np.float32)
    plain = M3ViTServer(cfg, params, device=dev)
    mesh = M3ViTServer(cfg, params, rules=rules, resident_fraction=0.5,
                       device=dev)
    for task in MV.TASKS:
        want = plain.infer(imgs, task)
        mesh.infer(imgs, task)                          # warm-up
        got, counts, coll = _counted(lambda: mesh.infer(imgs, task))
        if tp == 1:
            ok = np.array_equal(got, want)
            what = f"bit-equal to no mesh {ok}"
        else:
            g, w = torch.from_numpy(got), torch.from_numpy(want)
            c = cosine(g, w)
            ok = c >= SERVE_COSINE
            what = (f"MLPs over {tp} ranks: cosine {c:.6f} of no mesh "
                    f"(>= {SERVE_COSINE}: {ok}), max abs err "
                    f"{max_abs_err(g, w):.3e}")
        say(f"M3ViT {task} batch 8, paged 0.5 expert-parallel: {what}; "
            f"launches {json.dumps(counts)}; collectives {json.dumps(coll)}")
        if not ok:
            raise AssertionError(f"rank {rank}: M3ViT {task} differs")
    st = mesh.cache_stats()
    say(f"  walls semseg: {_wall_ms(lambda: mesh.infer(imgs, 'semseg')):.3f}"
        f" ms with the mesh, "
        f"{_wall_ms(lambda: plain.infer(imgs, 'semseg')):.3f} ms without; "
        f"shard_load {st['shard_load']} imbalance "
        f"{st['shard_load_imbalance']:.3f}, hit_rate {st['hit_rate']:.3f}")

    layer = plain.layer_params[1]["moe"]
    g = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn((8, 128, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    with ops.use_policy(policy):
        want, _ = moe_lib.apply_moe(layer, plain.mcfg, h)
        ep = replace(plain.mcfg, impl="ep_local")
        with use_rules(rules):
            got, counts, coll = _counted(
                lambda: moe_lib.apply_moe(layer, ep, h))
    ok = bool(within_tolerance(got[0], want, torch.bfloat16))
    say(f"apply_moe_ep_local against grouped: max abs err "
        f"{max_abs_err(got[0], want):.3e}, within the bf16 tolerance {ok}; "
        f"launches {json.dumps(counts)}; collectives {json.dumps(coll)}")
    if not ok:
        raise AssertionError(f"rank {rank}: ep_local outside tolerance")
    del plain, mesh, params


def deepseek(rules, dev, pol, smoke, say, agree) -> None:
    """DeepSeek-67B: at 16 layers against one card, then at all 95, each
    rank's blocks drawn on its card."""
    from repro_torch import ops
    from repro_torch.configs import get
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    rank = dist.get_rank()
    full = get("deepseek_67b", smoke=smoke)
    scfg = ServeConfig(max_len=512, policy=pol)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, full.vocab_size, size=(8, 128))).to(dev)

    cut = full if smoke else replace(full, num_layers=DEEPSEEK_CUT)
    whole = LM.init_params(0, cut, device=dev, draw_on_device=not smoke)
    plain = ServingEngine(cut, whole, scfg, device=dev)
    want = plain.generate(prompts, 32)
    plain_logits = _forced(plain, None, prompts, want, FORCED)
    del plain, whole
    if not smoke:
        torch.cuda.empty_cache()
    mine = LM.init_params(0, cut, device=dev, draw_on_device=not smoke,
                          rules=rules)
    mesh = ServingEngine(cut, mine, scfg, rules=rules, device=dev)
    mesh.generate(prompts, 2)
    got, counts, coll = _counted(lambda: mesh.generate(prompts, 32))
    say(f"DeepSeek-67B ({cut.num_layers} of {get('deepseek_67b').num_layers}"
        f" layers, each rank's blocks drawn on its card) 8 x 128 prompts, 32 "
        f"greedy tokens, against one card's run from the same seed: "
        f"launches {json.dumps(counts)}; collectives {json.dumps(coll)}")
    agree(f"DeepSeek-67B ({cut.num_layers} layers)", got, want, mesh,
          plain_logits, prompts)
    del mesh, mine, plain_logits
    if not smoke:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    mine = LM.init_params(0, full, device=dev, draw_on_device=not smoke,
                          rules=rules)
    _sync()
    draw_s = time.perf_counter() - t0
    held = sum(v.numel() * v.element_size() for v in mine.values())
    engine = ServingEngine(full, mine, scfg, rules=rules, device=dev)
    engine.generate(prompts, 2)                        # warm-up
    got, counts, coll = _counted(lambda: engine.generate(prompts, 32))
    moved = {}
    for c in ops.collective_report():
        key = f"{c['kind']}:{c['axis']}:{c['where']}"
        moved[key] = [c["count"], c["bytes"]]
    toks = torch.as_tensor(got, device=dev)
    every = [torch.empty_like(toks) for _ in range(dist.get_world_size())]
    dist.all_gather(every, toks)
    same = all(torch.equal(t, toks) for t in every)
    first = _forced(engine, rules, prompts, got, 0)[0]
    finite = bool(torch.isfinite(first).all())
    prefill, _ = engine.steps(0)
    state = engine.new_state(8)

    def run_prefill():
        from repro_torch.dist.sharding import use_rules

        with torch.inference_mode(), use_rules(rules):
            prefill(engine.params, prompts, state)

    prefill_ms = _wall_ms(run_prefill)
    gen_ms = _wall_ms(lambda: engine.generate(prompts, 32))
    step_ms = (gen_ms - prefill_ms) / 32
    peak = torch.cuda.max_memory_allocated() / 2**30 if not smoke else 0.0
    prof = {}
    if not smoke:
        from repro_torch.train.profile import profile_steps

        prof = profile_steps(lambda: engine.generate(prompts, 32), 1,
                             gen_ms / 1e3)
    say(f"DeepSeek-67B at all {full.num_layers} layers over "
        f"{dist.get_world_size()} ranks: {held / 2**30:.2f} GiB of weights a "
        f"rank drawn on its card in {draw_s:.1f} s; 8 x 128 prompts, 32 "
        f"greedy tokens: the same tokens on every rank {same}, finite "
        f"logits {finite}")
    say(f"  prefill {prefill_ms:.3f} ms, {step_ms:.3f} ms a decode step, "
        f"{8 * 32 / (gen_ms / 1e3):.1f} tokens/s (host walls, median of 3; "
        f"generate {gen_ms:.1f} ms); peak {peak:.2f} GiB a rank (rank "
        f"{rank})")
    say(f"  launches {json.dumps(counts)}")
    say(f"  collectives (count, bytes a rank) {json.dumps(moved)}")
    if prof:
        say(f"  profiled generate: busy {prof['busy_ms']:.1f} ms, "
            f"collectives' device time {prof['collective_ms']:.1f} ms, idle "
            f"share {prof['idle_share']:.3f}")
    print(f"  rank {rank}: peak {peak:.2f} GiB, same tokens {same}",
          flush=True)
    if not (same and finite):
        raise AssertionError(f"rank {rank}: DeepSeek-67B at full depth")



def fsdp_deepseek(rules, dev, pol, smoke, say) -> None:
    """``--fsdp``: DeepSeek-67B with serving's weights FSDP (see the
    module's docstring)."""
    from repro_torch import ops
    from repro_torch.configs import get
    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import (ShardingRules, _axes,
                                           param_sharding_rules)
    from repro_torch.kernels.compare import cosine, serving_agrees
    from repro_torch.models import model as LM
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    rank, world = dist.get_rank(), dist.get_world_size()
    full = get("deepseek_67b", smoke=smoke)
    scfg = ServeConfig(max_len=512, policy=pol)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, full.vocab_size, size=(8, 128))).to(dev)
    gib = 2**30

    def table_bytes(cfg, r) -> int:
        """A rank's bytes of the model at the table's blocks."""
        shapes, total = LM.param_specs(cfg), 0
        for name, sh in param_sharding_rules(shapes, r).items():
            split = 1
            for a in (a for e in sh.spec for a in _axes(e)):
                split *= spmd.axis_size(r.mesh, a)
            total += shapes[name].numel() * shapes[name].element_size() \
                // split
        return total

    def serve(label, cfg, r, forced_on=None):
        """Draw this rank's blocks under ``r``, serve, report; returns the
        tokens and, with ``forced_on`` (tokens, or ``"own"``: this run's),
        the logits teacher-forced on them."""
        if not smoke:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mine = LM.init_params(0, cfg, device=dev, draw_on_device=not smoke,
                              rules=r)
        _sync()
        draw_s = time.perf_counter() - t0
        held = sum(v.numel() * v.element_size() for v in mine.values())
        engine = ServingEngine(cfg, mine, scfg, rules=r, device=dev)
        engine.generate(prompts, 2)                    # warm-up
        got, counts, coll = _counted(lambda: engine.generate(prompts, 32))
        moved = {f"{c['kind']}:{c['axis']}:{c['where']}":
                 [c["count"], c["bytes"]] for c in ops.collective_report()}
        toks = torch.as_tensor(got, device=dev)
        every = [torch.empty_like(toks) for _ in range(world)]
        dist.all_gather(every, toks)
        same = all(torch.equal(t, toks) for t in every)
        prefill, _ = engine.steps(0)
        state = engine.new_state(8)

        def run_prefill():
            from repro_torch.dist.sharding import use_rules

            with torch.inference_mode(), use_rules(r):
                prefill(engine.params, prompts, state)

        prefill_ms = _wall_ms(run_prefill)
        gen_ms = _wall_ms(lambda: engine.generate(prompts, 32))
        peak = torch.cuda.max_memory_allocated() / gib if not smoke else 0.0
        prof = {}
        if not smoke:
            from repro_torch.train.profile import profile_steps

            prof = profile_steps(lambda: engine.generate(prompts, 32), 1,
                                 gen_ms / 1e3)
        table = table_bytes(cfg, r) if r.fsdp else held
        say(f"{label}: weights {held / gib:.3f} GiB a rank (the table's "
            f"blocks {table / gib:.3f}), drawn on its card in "
            f"{draw_s:.1f} s; the same tokens on every rank {same}")
        say(f"  prefill {prefill_ms:.3f} ms, "
            f"{(gen_ms - prefill_ms) / 32:.3f} ms a decode step, "
            f"{8 * 32 / (gen_ms / 1e3):.1f} tokens/s (host walls, median "
            f"of 3; generate {gen_ms:.1f} ms); peak {peak:.2f} GiB a rank "
            f"(rank {rank})")
        say(f"  launches {json.dumps(counts)}; collectives {json.dumps(coll)}")
        say(f"  collectives (count, bytes a rank) {json.dumps(moved)}")
        if prof:
            say(f"  profiled generate: busy {prof['busy_ms']:.1f} ms, "
                f"collectives' device time {prof['collective_ms']:.1f} ms, "
                f"idle share {prof['idle_share']:.3f}")
        if not same or (r.fsdp and abs(held / table - 1) > 0.01):
            raise AssertionError(f"rank {rank}: {label}: same tokens "
                                 f"{same}, held {held} of {table}")
        logits = None if forced_on is None else _forced(
            engine, r, prompts,
            got if isinstance(forced_on, str) else forced_on,
            FORCED)
        del engine, mine
        return got, logits

    def mesh_rules_of(shape, fsdp):
        return ShardingRules.for_mesh(spmd.init_mesh(
            shape, device_type=dev.type), fsdp=fsdp)

    shape = tuple(spmd.axis_size(rules.mesh, a) for a in ("data", "model"))
    name = "x".join(map(str, shape))
    depth = f"all {full.num_layers} layers"
    want, _ = serve(f"DeepSeek-67B ({depth}) over {name}, fsdp=False",
                    full, mesh_rules_of(shape, False))
    got, _ = serve(f"DeepSeek-67B ({depth}) over {name}, fsdp=True", full,
                   mesh_rules_of(shape, True))
    same = np.array_equal(got, want)
    say(f"  {name} fsdp=True tokens bit-equal to fsdp=False: {same}")
    if not same:
        raise AssertionError(f"rank {rank}: FSDP tokens differ over {name}")
    data, fsdp_logits = serve(
        f"DeepSeek-67B (all {full.num_layers} layers) over {world}x1, "
        f"fsdp=True", full, mesh_rules_of((world, 1), True), forced_on="own")
    _, tp_logits = serve(f"DeepSeek-67B (all {full.num_layers} layers) over "
                         f"1x{world}, fsdp=False (tensor-parallel)", full,
                         mesh_rules_of((1, world), False), forced_on=data)
    cos = [cosine(a, b) for a, b in zip(fsdp_logits, tp_logits)]
    ok = serving_agrees(cos)
    say(f"  {world}x1 FSDP against 1x{world} tensor-parallel: logits of the "
        f"prefill and {FORCED} teacher-forced steps at cosine "
        f"{min(cos):.6f}..{max(cos):.6f} (serving_agrees: {ok})")
    if not ok:
        raise AssertionError(f"rank {rank}: {world}x1 FSDP against "
                             f"1x{world}: {cos}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    main()
