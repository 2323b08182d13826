"""Driver of the vision cells: M³ViT frames through the port's scheduler.

``Scheduler(VisionBackend, total_slots, quantum)`` keeps one bucket of
``total_slots / tasks`` frames per task and runs a bucket's batch through
``M3ViTServer.infer`` every quantum, a partial batch padded.  Closed loop
(``"loop": "closed"``): each client sends a frame for every task and its
next frame once all its results are on the host; a frame's latency runs
from its hand-over to its last result.  Open loop (``"loop": "open"``):
cameras send one task's frame each on the traffic file's schedule, and a
frame's latency runs from when it was due.

The window's frames are drained after it closes; a seeded sample of them
is then held to the plain reference (``reference/vit_moe.py``): the mean
over the sampled answers of each answer's relative L2 error, against the
configuration's ``check`` limit ``rel_err_mean``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ebench import traffic as T
from ebench import weights, work
from ebench.common import (DRAIN_S, Reservoir, free, memory_peak, now,
                           reset_peak, settle, sync)
from ebench.stats import percentile
from ebench.tracing import Tracer


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` of the configuration file."""
    from repro_torch import ops
    from repro_torch.configs import m3vit as MV
    from repro_torch.configs.base import ArchConfig, MoESpec

    # the program keeps the frame's geometry, the task names and the norm's
    # epsilon as constants: the file has to agree with them
    fixed = {"image_h": MV.IMAGE_H, "image_w": MV.IMAGE_W,
             "patch": MV.PATCH, "num_seg_classes": MV.NUM_SEG_CLASSES,
             "tasks": list(MV.TASKS), "norm_eps": 1e-6}
    for key, want in fixed.items():
        if cfg[key] != want:
            raise ValueError(f"{cfg['name']}: {key} {cfg[key]!r} but the "
                             f"port serves {want!r}")
    pol = cfg["policy"]
    policy = ops.policy_named(pol["preset"]).with_impls(
        **pol.get("impls", {}))
    return ArchConfig(
        name=cfg["name"], family="vit-moe", num_layers=cfg["num_layers"],
        d_model=cfg["d_model"], num_heads=cfg["num_heads"],
        num_kv_heads=cfg["num_heads"], d_ff=cfg["d_ff"], vocab_size=0,
        block_pattern=tuple(cfg["block_pattern"]), mlp_kind="gelu",
        norm="layernorm", rope="none", embed_input="embeddings",
        moe=MoESpec(num_experts=cfg["num_experts"], top_k=cfg["top_k"],
                    d_ff=cfg["expert_d_ff"], num_tasks=cfg["num_tasks"],
                    capacity_factor=cfg["capacity_factor"], impl="grouped",
                    group_size=cfg["group_size"]),
        num_tasks=cfg["num_tasks"], dtype=cfg["dtype"], policy=policy)


def image_pool(cfg: dict, n: int, seed: int, device) -> np.ndarray:
    """``n`` float32 frames (H, W, 3) from the seed, drawn on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + 0x5EED) % 2**63)
    x = torch.randn((n, cfg["image_h"], cfg["image_w"], 3), generator=gen,
                    device=device)
    return x.cpu().numpy()


class Frame:
    __slots__ = ("client", "image", "due", "pending", "results", "t_done")

    def __init__(self, client, image, due, tasks):
        self.client, self.image, self.due = client, image, due
        self.pending = set(tasks)
        self.results = {}
        self.t_done = None


def run(ctx) -> dict:
    from repro_torch.serve.scheduler import Request, Scheduler
    from repro_torch.serve.vision import VisionBackend

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    arch = arch_config(cfg)
    phases = [("start", ctx.elapsed())]
    params = weights.draw(cfg, ctx.seed, dev)
    phases.append(("weights", ctx.elapsed()))
    backend = VisionBackend(arch, params,
                            resident_fraction=cfg["serve"][
                                "resident_fraction"], device=dev)
    server = backend.server
    phases.append(("program", ctx.elapsed()))
    n_tasks = len(cfg["tasks"])
    sc = tr["scheduler"]
    slots = sc["total_slots"] // n_tasks
    pool = image_pool(cfg, tr["image_pool"], ctx.seed, dev)
    batch = pool[np.arange(slots) % len(pool)]
    for _ in range(2):          # every shape the window uses: a full bucket
        for task in range(n_tasks):
            server.infer(batch, task)
    sync(dev)
    warm_peak = memory_peak(dev)
    phases.append(("warm-up", ctx.elapsed()))

    sched = Scheduler(backend, total_slots=sc["total_slots"],
                      quantum=sc["quantum"], clock=time.perf_counter)
    tracer = Tracer(dev)
    peak = work.peaks(torch.cuda.get_device_name(dev)) \
        if dev.type == "cuda" else None
    traced_calls = []
    orig_infer = server.infer

    def infer(images, task):
        with tracer.span("infer"):
            out = orig_infer(images, task)
        if tracer.on:
            traced_calls.append((images.shape[0], int(task)))
        return out

    server.infer = infer
    closed = tr["loop"] == "closed"
    st = {"rid": 0, "by_rid": {}, "window": None, "resubmit": True,
          "next_k": {}}
    sample = Reservoir(tr["sample_frames"], ctx.seed)
    done_window, window_frames = [], []
    flops = [0.0]

    def submit(client: int, due: float, tasks):
        k = st["next_k"].get(client, 0)
        st["next_k"][client] = k + 1
        img = T.image_index(ctx.seed, len(pool), client, k)
        fr = Frame(client, img, due, tasks)
        w = st["window"]
        if w is not None and w[0] <= due and (w[1] is None or due < w[1]):
            window_frames.append(fr)
        for task in tasks:
            st["by_rid"][st["rid"]] = fr
            sched.submit(Request(rid=st["rid"], task_id=task,
                                 prompt=pool[img], arrival=due))
            st["rid"] += 1

    def harvest():
        finished, sched.finished = sched.finished, []
        for r in finished:
            fr = st["by_rid"].pop(r.rid)
            fr.pending.discard(r.task_id)
            fr.results[r.task_id] = r.result
            r.result = None
            fr.t_done = r.t_done
            if fr.pending:
                continue
            w = st["window"]
            if w is not None and fr.t_done >= w[0] and (
                    w[1] is None or fr.t_done < w[1]):
                done_window.append(fr)
                flops[0] += sum(work.vit_frame_flops(cfg, t)
                                for t in fr.results)
                sample.offer(lambda fr=fr: (fr.image, {
                    t: np.array(y) for t, y in fr.results.items()}))
            fr.results = {}
            if st["resubmit"] and closed:
                submit(fr.client, sched.now(), range(n_tasks))

    def step():
        with tracer.span("step"):
            ran = sched.step()
        with tracer.span("harvest"):
            harvest()
        if not ran:
            time.sleep(0.0002)

    arrivals, nxt = [], [0]
    horizon = tr.get("preroll_s", 0.0) + ctx.seconds + DRAIN_S
    if not closed:
        arrivals = T.open_arrivals(tr, ctx.seed, horizon)
        half = tr["cameras"] // n_tasks

    def feed():
        t = sched.now()
        while nxt[0] < len(arrivals) and arrivals[nxt[0]][0] <= t:
            due, cam = arrivals[nxt[0]]
            nxt[0] += 1
            if st["resubmit"]:
                submit(cam, due, [min(cam // half, n_tasks - 1)])

    sched.now()                         # the scheduler's clock starts
    if closed:
        for c in range(tr["clients"]):
            submit(c, 0.0, range(n_tasks))
        while len(done_window) < tr["clients"]:
            st["window"] = (0.0, None)
            step()
        done_window.clear()
        window_frames.clear()
        flops[0] = 0.0
        sample = Reservoir(tr["sample_frames"], ctx.seed)
    else:
        while sched.now() < tr.get("preroll_s", 0.0):
            feed()
            step()
    settle(tracer, ctx.trace)
    setup_s = ctx.elapsed()
    phases.append(("preroll", ctx.elapsed()))
    reset_peak(dev)

    t0 = sched.now()
    st["window"] = (t0, None)
    buckets0 = _bucket_counts(sched)
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
        if not closed:
            feed()
        step()
    t1 = sched.now()
    buckets1 = _bucket_counts(sched)
    if tracer.on:
        tracer.stop()
    backlog = sum(1 for f in window_frames if f.pending)
    st["window"] = (t0, t1)
    rate = len(done_window) / (t1 - t0)
    st["resubmit"] = False
    limit = now() + DRAIN_S
    while any(f.t_done is None or f.pending for f in window_frames) \
            and now() < limit:
        step()
    window_peak = memory_peak(dev)
    lat = [(f.t_done - f.due) for f in window_frames
           if f.t_done is not None and not f.pending]
    failed = len(window_frames) - len(lat)

    counters = {"window_s": t1 - t0, "model_flops": flops[0],
                "peak_bytes": window_peak, "frame_lats_s": lat,
                "bucket_steps": buckets1[0] - buckets0[0],
                "bucket_slot_steps": buckets1[1] - buckets0[1],
                "bucket_slots": slots}
    if not closed:
        counters["backlog_at_close"] = backlog
        counters["due"] = len(window_frames)
    trace = None
    if ctx.trace and tracer.prof is not None:
        trace = tracer.summary()
        if peak is not None:
            bounds = {}
            for b, task in traced_calls:
                work.vit_batch_kernels(cfg, b, task, bounds, peak)
            trace["bounds"] = {k: v.seconds for k, v in bounds.items()}

    server.infer = orig_infer
    del sched, backend, server, orig_infer, infer, batch
    free(dev)
    ref = ctx.reference
    control, errs = [], []
    for image, results in sample.items:
        x = torch.from_numpy(pool[image][None]).to(dev)
        for task, got in results.items():
            want = ref.forward(params, cfg, x, task)[0]
            g = torch.from_numpy(got).to(dev).float()
            errs.append(float((g - want).norm() / want.norm()))
            if ctx.control:
                low = ref.forward(params, cfg, x, task, mode="fp8")[0]
                control.append(float((low - want).norm() / want.norm()))
    checks = {"rel_err_mean": (sum(errs) / len(errs) if errs else math.inf,
                               ctx.config["check"]["rel_err_mean"])}
    out = {
        "e2e": {"frames_per_s": rate,
                "frame_p95_ms": (percentile(lat, 95) or math.inf) * 1e3,
                "setup_s": setup_s},
        "attempted": len(window_frames), "failed": failed,
        "memory_peak_bytes": max(warm_peak, window_peak),
        "counters": counters, "trace": trace, "phases": phases,
        "checks": checks, "sampled": len(errs)}
    out["errors"] = errs
    if ctx.control:
        out["control"] = {"rel_err_mean": sum(control) / len(control)}
        out["control_errors"] = control
    return out


def _bucket_counts(sched):
    steps = sum(b.steps for b in sched.buckets.values())
    return steps, sum(b.slot_steps for b in sched.buckets.values())
