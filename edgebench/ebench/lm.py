"""Driver of the decoder cells: chat-like traffic through the port's
scheduler.

``Scheduler(LMBackend, total_slots, quantum)`` admits each prompt alone
(a batch-1 prefill spliced into a free slot) and decodes every live slot
one token a step, greedily.  ``clients`` closed-loop clients each send
their next request the moment the last one finishes.  Before the window
the loop runs until every client has finished one request, so the window
starts from clients out of step, as in steady traffic.

Tokens per second count every output token emitted in the window over
its length; time to first token runs from a request's hand-over to its
first token, over every request handed over in the window (the loop runs
on past the close until each has one).  A seeded sample of the finished
requests, the one with the most served tokens among them, is then held to
the plain reference (``reference/dense_lm.py``): the widest gap by which a
served token's logit lies below the reference's best at its position.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ebench import traffic as T
from ebench import weights, work
from ebench.common import (DRAIN_S, free, memory_peak, now, reset_peak,
                           settle, sync)
from ebench.stats import percentile
from ebench.tracing import Tracer


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` of a configuration file in the keys of
    the model's ``config.json``."""
    from repro_torch import ops
    from repro_torch.configs.base import ArchConfig

    if cfg["rms_norm_eps"] != 1e-6 or cfg["hidden_act"] != "silu":
        raise ValueError(f"{cfg['name']}: the port's RMSNorm takes eps "
                         "1e-6 and its decoders' MLP SiLU")
    pol = cfg["policy"]
    policy = ops.policy_named(pol["preset"]).with_impls(
        **pol.get("impls", {}))
    return ArchConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        mlp_kind="swiglu", norm="rmsnorm", rope="rope",
        rope_theta=cfg["rope_theta"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["torch_dtype"],
        policy=policy)


def run(ctx) -> dict:
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import LMBackend, Request, Scheduler

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    arch = arch_config(cfg)
    phases = [("start", ctx.elapsed())]
    params = weights.draw(cfg, ctx.seed, dev)
    phases.append(("weights", ctx.elapsed()))
    sv = cfg["serve"]
    backend = LMBackend(arch, params,
                        ServeConfig(max_len=sv["max_len"], eos_id=-1,
                                    temperature=0.0),
                        prompt_pad=sv["prompt_pad"], device=dev)
    phases.append(("program", ctx.elapsed()))
    sc = tr["scheduler"]
    sched = Scheduler(backend, total_slots=sc["total_slots"],
                      quantum=sc["quantum"], clock=time.perf_counter)
    gen = T.ClosedLM(tr, ctx.seed, cfg["vocab_size"])
    tracer = Tracer(dev)
    peak = work.peaks(torch.cuda.get_device_name(dev)) \
        if dev.type == "cuda" else None
    rec = {"on": False, "flops": 0.0, "prefills": [], "decodes": []}

    orig_admit, orig_decode = backend.admit_step, backend.decode_step

    def admit_step(task_id):
        fn = orig_admit(task_id)

        def admit(params_, inputs, big, slot, last_idx):
            with tracer.span("admit"):
                out = fn(params_, inputs, big, slot, last_idx)
            s0 = int(last_idx) + 1
            if rec["on"]:
                rec["flops"] += work.lm_prefill_flops(cfg, s0)
            if tracer.on:
                rec["prefills"].append(s0)
            return out
        return admit

    def decode_step():
        fn = orig_decode()

        def decode(params_, toks, state, cache_pos, task_ids):
            b = sched.buckets[None]
            lengths = [int(b.cache_pos[i]) + 1
                       for i, r in enumerate(b.reqs) if r is not None]
            if rec["on"]:
                rec["flops"] += work.lm_decode_flops(cfg, lengths)
            if tracer.on:
                rec["decodes"].append(lengths)
            with tracer.span("decode"):
                return fn(params_, toks, state, cache_pos, task_ids)
        return decode

    backend.admit_step, backend.decode_step = admit_step, decode_step

    st = {"rid": 0, "live": {}, "done_tokens": 0, "resubmit": True,
          "window": None, "next_k": {}}
    window_reqs, finished_log = [], []

    def submit(client: int, cut: float = 1.0):
        k = st["next_k"].get(client, 0)
        st["next_k"][client] = k + 1
        s0, n = gen.shape(client, k)
        n = max(1, round(cut * n))
        r = Request(rid=st["rid"], task_id=0,
                    prompt=gen.tokens(client, k, s0), max_new_tokens=n,
                    arrival=sched.now())
        r.tenant = client
        st["rid"] += 1
        st["live"][r.rid] = r
        if st["window"] is not None:
            window_reqs.append(r)
        sched.submit(r)

    def step():
        with tracer.span("step"):
            ran = sched.step()
        with tracer.span("harvest"):
            finished, sched.finished = sched.finished, []
            for r in finished:
                del st["live"][r.rid]
                st["done_tokens"] += len(r.tokens)
                if st["window"] is not None:
                    finished_log.append(r)
                if st["resubmit"]:
                    submit(r.tenant)
        if not ran:
            time.sleep(0.0002)
        return len(finished)

    def emitted() -> int:
        return st["done_tokens"] + sum(len(r.tokens)
                                       for r in st["live"].values())

    # warm-up: the longest and the shortest prompt of the mix, through the
    # scheduler (the decode step's shape does not depend on the live lanes)
    st["resubmit"] = False
    for s0 in (gen.longest_prompt(), gen.shortest_prompt()):
        for _ in range(2):
            r = Request(rid=st["rid"], task_id=0,
                        prompt=gen.tokens(tr["clients"], st["rid"], s0),
                        max_new_tokens=2, arrival=sched.now())
            st["rid"] += 1
            st["live"][r.rid] = r
            sched.submit(r)
        while st["live"]:
            step()
    sync(dev)
    warm_peak = memory_peak(dev)
    phases.append(("warm-up", ctx.elapsed()))
    # the clients' first requests, their answers cut to a fixed share so
    # they finish out of step; the window opens once half have finished
    st["resubmit"] = True
    cuts = np.random.default_rng([ctx.seed % 2**63, 9]).uniform(
        0.0, 1.0, tr["clients"])
    for c in range(tr["clients"]):
        submit(c, float(cuts[c]))
    done = 0
    while done < tr["clients"] // 2:
        done += step()
    settle(tracer, ctx.trace)
    setup_s = ctx.elapsed()
    phases.append(("preroll", ctx.elapsed()))
    reset_peak(dev)

    t0 = sched.now()
    st["window"] = t0
    rec["on"] = True
    tok0 = emitted()
    # the traced stretch closes the window; the profiler's stop, which
    # digests the trace, falls after it
    t_trace = t0 + max(0.0, ctx.seconds - tr["trace_s"])
    while True:
        t = sched.now()
        if t >= t0 + ctx.seconds:
            break
        if ctx.trace and not tracer.on and tracer.prof is None \
                and t >= t_trace:
            tracer.start()
        step()
    t1 = sched.now()
    tok1 = emitted()
    rec["on"] = False
    if tracer.on:
        tracer.stop()
    in_window = [r for r in window_reqs if r.arrival < t1]
    limit = now() + DRAIN_S
    while any(r.t_first is None for r in in_window) and now() < limit:
        step()
    window_peak = memory_peak(dev)
    ttft = [r.t_first - r.arrival for r in in_window
            if r.t_first is not None]
    # the per-layer spans: requests admitted, and finished, in the window
    tpot = [(r.t_done - r.t_first) / (len(r.tokens) - 1) for r in in_window
            if r.t_done is not None and r.t_done < t1 and len(r.tokens) > 1]
    counters = {"window_s": t1 - t0, "model_flops": rec["flops"],
                "peak_bytes": window_peak,
                "admit_waits_s": [r.t_admit - r.arrival for r in in_window
                                  if r.t_admit is not None
                                  and r.t_admit < t1],
                "ttfts_s": ttft, "tpots_s": tpot}
    trace = None
    if ctx.trace and tracer.prof is not None:
        trace = tracer.summary()
        if peak is not None:
            bounds = {}
            for s0 in rec["prefills"]:
                work.lm_prefill_kernels(cfg, s0, bounds, peak)
            for lengths in rec["decodes"]:
                work.lm_decode_kernels(cfg, lengths, bounds, peak)
            trace["bounds"] = {k: v.seconds for k, v in bounds.items()}

    attempted = len(in_window)
    failed = sum(r.t_first is None for r in in_window)
    served = [(np.asarray(r.prompt), list(r.tokens)) for r in finished_log]
    del sched, backend, orig_admit, orig_decode, admit_step, decode_step
    del window_reqs, finished_log, in_window
    free(dev)
    sample = pick(served, tr["check_requests"], tr["check_tokens"],
                  ctx.seed)
    gaps, control = [], []
    ref = ctx.reference
    for prompt, toks in sample:
        seq = torch.from_numpy(np.concatenate(
            [prompt, np.asarray(toks[:-1], np.int64)])).to(dev)
        rows = list(range(len(prompt) - 1, len(prompt) - 1 + len(toks)))
        want = ref.logits_at(params, cfg, seq, rows)
        best = want.max(-1).values
        got = torch.as_tensor(toks, device=dev)
        gaps.append(float((best - want.gather(
            1, got[:, None])[:, 0]).max()))
        if ctx.control:
            low = ref.logits_at(params, cfg, seq, rows, mode="fp8")
            pick_low = low.argmax(-1)
            control.append(float((best - want.gather(
                1, pick_low[:, None])[:, 0]).max()))
        del want
    out = {
        "e2e": {"tokens_per_s": (tok1 - tok0) / (t1 - t0),
                "ttft_p95_ms": (percentile(ttft, 95) or math.inf) * 1e3,
                "setup_s": setup_s},
        "attempted": attempted, "failed": failed,
        "memory_peak_bytes": max(warm_peak, window_peak),
        "counters": counters, "trace": trace, "phases": phases,
        "checks": {"logit_gap_max": (max(gaps) if gaps else math.inf,
                                     ctx.config["check"]["logit_gap_max"])},
        "sampled": sum(len(t) for _, t in sample)}
    out["errors"] = gaps
    if ctx.control:
        out["control"] = {"logit_gap_max": max(control)}
        out["control_errors"] = control
    return out


def pick(served, requests: int, tokens: int, seed: int):
    """The finished request with the most served tokens, then others in a
    seeded order until the sample holds ``requests`` requests and
    ``tokens`` served tokens."""
    if not served:
        return []
    order = sorted(range(len(served)), key=lambda i: -len(served[i][1]))
    rest = list(np.random.default_rng([seed % 2**63, 8]).permutation(
        order[1:]))
    out, n = [], 0
    for i in [order[0]] + rest:
        out.append(served[i])
        n += len(served[i][1])
        if n >= tokens and len(out) >= requests:
            break
    return out
