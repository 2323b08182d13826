"""The M³ViT scheduler backend (``repro_torch.serve.vision.VisionBackend``)
on the CPU, beside the JAX reference's (``repro.serve.vision``).

The reference's oracles (``tests/test_vision_serve.py:49`` and ``:69``,
``tests/test_slo_serve.py``'s vision bump): both tasks served through
per-task buckets with paged experts, results equal to a direct ``infer``
of the same frames (under the port's kernel policy ``cuda``, each kernel
module running its plain version on the CPU), and the SLO bump
result-identical.  Beside them, on ``SMOKE_CONFIG`` at float32 with exact
activations (the port's ``eager``, the reference's ``xla``, as in
``test_torch_expert_cache.py``): the scheduler finishes the requests in
the reference's order at the reference's tick times, its results within
1e-4 of the reference's, and the expert cache's counters equal.
"""

import functools
from dataclasses import replace

import jax
import numpy as np
import pytest

from repro import ops as jops
from repro.configs import m3vit as JM
from repro.models import vit as jvit
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler
from repro.serve.slo import SLOPolicy as JSLOPolicy
from repro.serve.slo import TickClock as JTickClock
from repro.serve.vision import VisionBackend as JVisionBackend
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.configs import m3vit as TM
from repro_torch.serve import Request, Scheduler, VisionBackend
from repro_torch.serve.slo import SLOPolicy, TickClock
from test_torch_threads import one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def _model(port_policy="eager"):
    jcfg = replace(JM.SMOKE_CONFIG, dtype="float32",
                   policy=jops.policy_named("xla"))
    tcfg = replace(TM.SMOKE_CONFIG, dtype="float32",
                   policy=ops.policy_named(port_policy))
    jparams = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams),
                                                device="cpu")


def _images(b, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, TM.IMAGE_H, TM.IMAGE_W, 3)).astype(np.float32)


def test_scheduler_serves_both_tasks_as_the_reference():
    """Six requests of both tasks through buckets of 2 at half residency:
    the reference's finishing order and times, results within 1e-4 of its,
    the same cache counters."""
    jcfg, tcfg, jparams, tparams = _model()
    imgs = _images(2)
    specs = [dict(rid=i, task_id=i % 2, prompt=imgs[i % 2])
             for i in range(6)]
    jb = JVisionBackend(jcfg, jparams, resident_fraction=0.5)
    tb = VisionBackend(tcfg, tparams, resident_fraction=0.5, device="cpu")
    js = JScheduler(jb, total_slots=4, quantum=1, num_tasks=2,
                    clock=JTickClock())
    ts = Scheduler(tb, total_slots=4, quantum=1, num_tasks=2,
                   clock=TickClock())
    js.run([JRequest(**s) for s in specs])
    done = ts.run([Request(**s) for s in specs])
    assert len(done) == 6
    for r in done:
        expect = (TM.IMAGE_H, TM.IMAGE_W, TM.NUM_SEG_CLASSES) \
            if r.task_id == 0 else (TM.IMAGE_H, TM.IMAGE_W)
        assert r.result.shape == expect, r.rid
    assert [r.rid for r in done] == [r.rid for r in js.finished]
    for j, t in zip(js.finished, done):
        assert (t.t_admit, t.t_done) == (j.t_admit, j.t_done), t.rid
        want = np.asarray(j.result)
        assert np.abs(t.result - want).max() <= 1e-4 * np.abs(want).max()
    m, jm = ts.metrics(), js.metrics()
    assert m["requests"] == 6 and m["items_per_s"] > 0
    assert m["slot_utilization"] == jm["slot_utilization"]
    cache, jcache = m["expert_cache"], jm["expert_cache"]
    assert cache["resident_fraction"] == pytest.approx(0.5)
    assert 0.0 <= cache["hit_rate"] <= 1.0
    assert cache["hits"] + cache["misses"] > 0
    for k in ("hits", "misses", "evictions", "bytes_paged"):
        assert cache[k] == jcache[k], k


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_scheduler_results_match_direct_batched_forward(frac):
    """Predictions served through the scheduler (buckets of 2, one batch
    padded by repeating its first image) equal a direct ``infer`` of the
    same frames through the same server, bit for bit."""
    _, tcfg, _, tparams = _model("cuda")
    imgs = _images(3, seed=2)
    tb = VisionBackend(tcfg, tparams, resident_fraction=frac, device="cpu")
    direct = tb.server.infer(imgs[:2], "depth")
    tail = tb.server.infer(imgs[[2, 2]], "depth")[0]
    sched = Scheduler(tb, total_slots=4, quantum=1, num_tasks=2)
    done = sched.run([Request(rid=i, task_id=1, prompt=imgs[i])
                      for i in range(3)])
    for r in done:
        want = direct[r.rid] if r.rid < 2 else tail
        np.testing.assert_array_equal(r.result, want)


def test_vision_slo_bump_is_result_identical():
    """Vision "preemption": a staged batch-tier request is bumped back to
    the queue so a due interactive one takes its batch seat — identical
    predictions, a later batch, counted; the same order as the
    reference's."""
    jcfg, tcfg, jparams, tparams = _model()
    imgs = _images(3, seed=0)

    def specs(t_interactive):
        return [dict(rid=0, task_id=0, prompt=imgs[0], arrival=0.0,
                     tier="batch"),
                dict(rid=1, task_id=1, prompt=imgs[1], arrival=0.0,
                     tier="batch"),
                dict(rid=2, task_id=0, prompt=imgs[2],
                     arrival=t_interactive, tier="interactive")]

    class JumpClock:
        t = 0.0

        def __call__(self):
            return self.t

    orders = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            back = JVisionBackend(jcfg, jparams, resident_fraction=1.0)
            mk, req, slo = JScheduler, JRequest, JSLOPolicy
        else:
            back = VisionBackend(tcfg, tparams, resident_fraction=1.0,
                                 device="cpu")
            mk, req, slo = Scheduler, Request, SLOPolicy
        ref = {r.rid: r for r in mk(back, total_slots=2, quantum=1,
                                    num_tasks=2).run(
            [req(**s) for s in specs(0.0)])}
        clock = JumpClock()
        # the lookahead hook runs between admission and the quantum: jump
        # the clock there so the interactive request becomes due while the
        # batch request holds the only staged seat
        back.lookahead = lambda task: setattr(clock, "t", 20.0)
        sched = mk(back, total_slots=2, quantum=1, num_tasks=2, clock=clock,
                   slo=slo(preemption=True))
        done = {r.rid: r for r in sched.run([req(**s)
                                             for s in specs(10.0)])}
        assert len(done) == 3
        assert sched.preemptions >= 1 and done[0].preemptions >= 1
        order = [r.rid for r in sched.finished]
        assert order.index(2) < order.index(0)
        for rid, r in done.items():
            assert np.array_equal(np.asarray(r.result),
                                  np.asarray(ref[rid].result)), rid
        orders.append((order, sched.preemptions))
    assert orders[0] == orders[1]


def test_backend_refuses_what_later_slices_port():
    """Meshes (queue 1 item 6a, ported) reach the server, whose MoE layers
    page expert-parallel; ``factor`` (item 3, ported) reaches the server,
    whose paged layers pin each layer's basis."""
    from _torch_mesh import rules_of_one

    _, tcfg, _, tparams = _model()
    mesh = VisionBackend(tcfg, tparams, device="cpu",
                         rules=rules_of_one(fsdp=False))
    assert mesh.server.paged and all(
        p.cache.num_shards == 1 for p in mesh.server.paged.values())
    backend = VisionBackend(tcfg, tparams, device="cpu",
                            factor=("rank", 4, 8))
    assert backend.server.paged and all(
        set(p.cache.pinned) == {"w1.basis", "w2.basis"}
        for p in backend.server.paged.values())
