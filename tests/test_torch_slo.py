"""SLO-aware serving in the port (``repro_torch.serve.slo`` and the
scheduler's tiers, preemption, chunked admission and prefix cache) against
the JAX reference, on the CPU.

* The copies (``tiers``, ``trace``, ``prefix``): the same requests from
  ``TraceGenerator`` for three seeds, the same goodput and SLO verdicts on
  the same finished lists, and the reference's trie tests.
* The scheduler under a ``TickClock``, the port beside the JAX scheduler
  on the same requests and parameters (float32, the helpers of
  ``test_torch_scheduler.py``): preempt/restore, chunk-interleaved
  admission and prefix reuse give every request the engine's tokens, and
  the same finishing order, times, preemptions, restores, per-tier counts,
  slot utilization and prefix-cache counters as the reference.  The prefix
  test admits one shared prefix three times: the port prefills in place,
  so an admission that continued from a cached entry without cloning it
  would change the entry under the next one.
* The reference's other oracles (``tests/test_slo_serve.py``,
  ``tests/test_prefix_cache.py``): the parker's bit-exact round trip, the
  TTFT/latency NaN and empty-metrics guards; with an int8 KV cache and
  int8 parking, preempted requests keep the uninterrupted run's tokens and
  the reference's schedule.
"""

import math
from dataclasses import fields

import numpy as np
import pytest
import torch

from repro.serve import Request as JRequest
from repro.serve.slo import TraceConfig as JTraceConfig
from repro.serve.slo import TraceGenerator as JTraceGenerator
from repro.serve.slo import tiers as jtiers
from repro_torch.serve import LMBackend, Request, Scheduler, ServeConfig
from repro_torch.serve.slo import (BATCH, INTERACTIVE, RadixPrefixCache,
                                   SLOPolicy, TraceConfig, TraceGenerator,
                                   goodput, meets_slo, request_tpot,
                                   tag_request)
from repro_torch.tree import flatten
from test_torch_scheduler import (_model, _prompts, assert_same_schedule,
                                  backend, engine, run_both)
from test_torch_threads import one_torch_thread  # noqa: F401

# ------------------------------------------------------------- the copies


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("prefix", [0, 16])
def test_trace_generator_gives_the_references_requests(seed, prefix):
    kw = dict(n=48, seed=seed, vocab=128256, num_tasks=2, burst_factor=8.0,
              shared_prefix_len=prefix)
    want = JTraceGenerator(JTraceConfig(**kw)).generate()
    got = TraceGenerator(TraceConfig(**kw)).generate()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name


def _finished(cls, seed):
    """Finished requests with assorted deadlines and times."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(24):
        r = cls(rid=i, task_id=i % 2, prompt=np.zeros(4, np.int32),
                max_new_tokens=8, arrival=float(rng.uniform(0, 1)))
        spec = (jtiers.INTERACTIVE if cls is JRequest else INTERACTIVE) \
            if i % 3 else (jtiers.BATCH if cls is JRequest else BATCH)
        (jtiers.tag_request if cls is JRequest else tag_request)(r, spec)
        if i % 7 == 0:
            continue                                 # never started
        r.t_first = r.arrival + float(rng.uniform(0, 0.6))
        r.tokens = list(range(int(rng.integers(1, 9))))
        if i % 5:
            r.t_done = r.t_first + float(rng.uniform(0, 1.2))
        out.append(r)
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_tiers_and_goodput_match_the_reference(seed):
    mine, theirs = _finished(Request, seed), _finished(JRequest, seed)
    assert [meets_slo(r) for r in mine] == [jtiers.meets_slo(r)
                                            for r in theirs]
    got = [request_tpot(r) for r in mine]
    want = [jtiers.request_tpot(r) for r in theirs]
    assert np.array_equal(np.array(got), np.array(want), equal_nan=True)
    assert goodput(mine, 2.5) == jtiers.goodput(theirs, 2.5)
    assert goodput([], 1.0) == jtiers.goodput([], 1.0)


def test_trie_lookup_longest_prefix_and_min_match():
    c = RadixPrefixCache(max_entries=8, min_match=4)
    c.insert([1, 2, 3, 4, 5, 6], "A", nbytes=10)
    state, m = c.lookup([1, 2, 3, 4, 5, 6, 7, 8])
    assert state == "A" and m == 6
    state, m = c.lookup([1, 2, 3, 4, 9, 9])
    assert state == "A" and m == 4
    state, m = c.lookup([1, 2, 9, 9, 9, 9])
    assert state is None and m == 0
    assert c.stats()["hits"] == 2 and c.stats()["lookups"] == 3


def test_trie_edge_split_and_deeper_entry_wins():
    c = RadixPrefixCache(max_entries=8, min_match=2)
    c.insert([1, 2, 3, 4], "short", nbytes=1)
    c.insert([1, 2, 3, 4, 5, 6], "long", nbytes=1)
    c.insert([1, 2, 9, 9], "fork", nbytes=1)
    state, m = c.lookup([1, 2, 3, 4, 5, 6])
    assert state == "long" and m == 6
    state, m = c.lookup([1, 2, 3, 4, 7])
    assert m == 4 and state in ("short", "long")
    state, m = c.lookup([1, 2, 9, 9, 1])
    assert state == "fork" and m == 4
    state, m = c.lookup([1, 2, 3, 4])
    assert m == 4


def test_trie_lru_eviction_prunes_nodes():
    c = RadixPrefixCache(max_entries=2, min_match=1)
    c.insert([1, 1, 1], "a", nbytes=5)
    c.insert([2, 2, 2], "b", nbytes=5)
    c.lookup([1, 1, 1])
    c.insert([3, 3, 3], "c", nbytes=5)
    assert c.stats()["evictions"] == 1
    state, m = c.lookup([2, 2, 2])
    assert state is None and m == 0
    assert c.lookup([1, 1, 1])[0] == "a"
    assert c.lookup([3, 3, 3])[0] == "c"
    assert c.nbytes == 10


def test_trie_duplicate_insert_refreshes():
    c = RadixPrefixCache(max_entries=4, min_match=1)
    c.insert([5, 6, 7], "v1", nbytes=3)
    c.insert([5, 6, 7], "v2", nbytes=4)
    assert c.stats()["entries"] == 1 and c.nbytes == 4
    assert c.lookup([5, 6, 7])[0] == "v2"


# ------------------------------------------------------ preempt / restore


def test_preempt_restore_token_identical_fp32():
    """One slot, a long batch request, an interactive arrival mid-decode:
    the batch request is parked, the interactive one served, the batch one
    restored — both token streams equal the engine's, and every decision
    the reference's."""
    _, tcfg, _, tparams = _model()
    scfg = dict(max_len=64)
    prompts = _prompts(tcfg.vocab_size, 2, 8, 3)
    ref = engine(tcfg, tparams, ServeConfig(**scfg)).generate(prompts, 24)
    specs = [dict(rid=0, task_id=0, prompt=prompts[0], max_new_tokens=24,
                  arrival=0.0, tier="batch"),
             dict(rid=1, task_id=0, prompt=prompts[1], max_new_tokens=4,
                  arrival=0.25, tier="interactive")]
    js, ts, _, _ = run_both(
        "llama3_2_1b", scfg, specs, total_slots=1, quantum=4, num_tasks=1,
        clock=True, slo=SLOPolicy(preemption=True, chunk_interleave=False))
    done = {r.rid: r for r in ts.finished}
    assert done[0].tokens == list(ref[0][:24])
    assert done[1].tokens == list(ref[1][:4])
    assert done[0].preemptions >= 1
    m = ts.metrics()
    assert m["preemptions"] >= 1 and m["restores"] >= 1
    assert m["parked_bytes_peak"] > 0 and m["parked_now"] == 0
    assert set(m["tiers"]) == {"batch", "interactive"}
    assert m["tiers"]["batch"]["preemptions"] >= 1
    assert m["goodput_rps"] > 0 and m["slo_attainment"] == 1.0
    assert_same_schedule(js, ts)


def test_preempt_restore_int8_kv_raises():
    """Once the packed-formats slice's to-do (it raised until then): with
    an int8 KV cache the parked leaves are already int8 (+ float32 row
    scales below the packing threshold), so ``park_compress="int8"``
    stores them verbatim and the round trip stays bit-exact — both token
    streams equal the uninterrupted int8-cache engine's, every decision
    the reference's."""
    _, tcfg, _, tparams = _model()
    scfg = dict(max_len=64, kv_quant="int8")
    prompts = _prompts(tcfg.vocab_size, 2, 8, 3)
    ref = engine(tcfg, tparams, ServeConfig(**scfg)).generate(prompts, 24)
    specs = [dict(rid=0, task_id=0, prompt=prompts[0], max_new_tokens=24,
                  arrival=0.0, tier="batch"),
             dict(rid=1, task_id=0, prompt=prompts[1], max_new_tokens=4,
                  arrival=0.25, tier="interactive")]
    js, ts, _, tb = run_both(
        "llama3_2_1b", scfg, specs, total_slots=1, quantum=4, num_tasks=1,
        clock=True, slo=SLOPolicy(preemption=True, chunk_interleave=False,
                                  park_compress="int8"))
    done = {r.rid: r for r in ts.finished}
    assert done[0].tokens == list(ref[0][:24])
    assert done[1].tokens == list(ref[1][:4])
    assert done[0].preemptions >= 1 and ts.metrics()["restores"] >= 1
    assert_same_schedule(js, ts)
    # the int8 leaves park verbatim: the parked bytes are the slot's
    bucket = tb.make_bucket(None, 2)
    parked = tb.parker("int8").park(bucket.state, 1)
    assert not any(isinstance(p, tuple) for p in parked.leaves)
    assert parked.nbytes * 2 == sum(
        t.numel() * t.element_size() for t in flatten(bucket.state).values())


def _one_admitted(tcfg, tparams, slots, new):
    b = backend(tcfg, tparams, ServeConfig(max_len=64))
    bucket = b.make_bucket(None, slots)
    req = Request(rid=0, task_id=0, prompt=_prompts(tcfg.vocab_size, 1, 8,
                                                    3)[0],
                  max_new_tokens=new, tier="batch")
    bucket.admit(req, 0.0)
    bucket.run_quantum(3, lambda: 0.0)
    return b, bucket


def test_parker_leaf_bit_exact_roundtrip():
    """park -> restore into the same slot reproduces every state leaf bit
    for bit, and the parked copy does not alias the bucket, which keeps
    decoding its other slots in place."""
    _, tcfg, _, tparams = _model()
    b, bucket = _one_admitted(tcfg, tparams, 2, 8)
    before = {k: v.clone() for k, v in flatten(bucket.state).items()}
    parker = b.parker("none")
    parked = bucket.park(0, parker)
    assert parked["cache_pos"] == 8 + 3   # prompt + decode steps taken
    bucket.restore(parked, parker)
    for name, leaf in flatten(bucket.state).items():
        assert leaf.dtype == before[name].dtype
        assert torch.equal(leaf, before[name]), name
    parked = bucket.park(0, parker)
    for leaf in flatten(bucket.state).values():
        leaf.fill_(7.0)                   # the bucket moves on in place
    assert bucket.restore(parked, parker) == 0
    for (name, leaf), ax in zip(flatten(bucket.state).items(),
                                parker.axes):
        assert torch.equal(leaf.narrow(ax, 0, 1),
                           before[name].narrow(ax, 0, 1)), name
        assert bool((leaf.narrow(ax, 1, 1) == 7.0).all())


def test_int8_parking_raises():
    """Once the packed-formats slice's to-do (it raised until then):
    ``compress="int8"`` on a floating cache packs the KV rows to int8 +
    float32 per-row scales — a real byte reduction (float32 rows here) —
    and the lossy restore still decodes the request to completion (the
    reference's ``test_int8_park_compresses_fp_state_and_decode_
    continues``); the rows come back within half a quantization step."""
    _, tcfg, _, tparams = _model()
    b, bucket = _one_admitted(tcfg, tparams, 1, 10)
    p_none = b.parker("none").park(bucket.state, 0)
    p_int8 = b.parker("int8").park(bucket.state, 0)
    # a float32 row of hd elements -> hd int8 values + one float32 scale
    hd = tcfg.hd
    assert p_int8.nbytes * 4 * hd == p_none.nbytes * (hd + 4)
    assert all(isinstance(p, tuple) for p in p_int8.leaves)
    parker = b.parker("int8")
    before = [t.clone() for t in flatten(bucket.state).values()]
    parked = bucket.park(0, parker)
    bucket.restore(parked, parker)
    for was, now, (q, scale) in zip(before, flatten(bucket.state).values(),
                                    parked["state"].leaves):
        assert bool(((was - now).abs() <= scale / 2 + 1e-7).all())
    done = []
    for _ in range(20):
        done += bucket.run_quantum(4, lambda: 0.0)
        if done:
            break
    assert done and len(done[0].tokens) == 10


def test_chunked_interleave_token_identical_and_non_blocking():
    """A 24-token prompt admitted at prefill_chunk=4 advances one chunk per
    decode step: the short interactive request finishes before the long
    prompt's first token, both token streams equal the engine's, and the
    schedule equals the reference's."""
    _, tcfg, _, tparams = _model()
    scfg = dict(max_len=64, prefill_chunk=4)
    long_p = _prompts(tcfg.vocab_size, 1, 24, 5)[0]
    short_p = _prompts(tcfg.vocab_size, 1, 4, 6)[0]
    eng = engine(tcfg, tparams, ServeConfig(**scfg))
    ref_long = eng.generate(long_p[None], 6)[0]
    ref_short = eng.generate(short_p[None], 4)[0]
    specs = [dict(rid=0, task_id=0, prompt=long_p, max_new_tokens=6,
                  arrival=0.0, tier="batch"),
             dict(rid=1, task_id=0, prompt=short_p, max_new_tokens=4,
                  arrival=0.0, tier="interactive")]
    js, ts, _, _ = run_both(
        "llama3_2_1b", scfg, specs, total_slots=2, quantum=4, num_tasks=1,
        clock=True, slo=SLOPolicy(preemption=False, chunk_interleave=True))
    done = {r.rid: r for r in ts.finished}
    assert done[0].tokens == list(ref_long[:6])
    assert done[1].tokens == list(ref_short[:4])
    assert done[1].t_done < done[0].t_first
    assert ts.metrics()["prefill_chunks"] >= 6
    assert_same_schedule(js, ts)


def test_ttft_latency_nan_until_finished():
    r = Request(rid=0, task_id=0, prompt=np.zeros(4, np.int32),
                max_new_tokens=2, arrival=5.0)
    assert math.isnan(r.ttft) and math.isnan(r.latency)
    assert math.isnan(r.tpot)
    r.t_first = 5.5
    assert r.ttft == pytest.approx(0.5) and math.isnan(r.latency)
    r.t_done = 6.0
    assert r.latency == pytest.approx(1.0)


def test_metrics_empty_and_partial_no_crash():
    _, tcfg, _, tparams = _model()
    sched = Scheduler(backend(tcfg, tparams, ServeConfig(max_len=64)),
                      total_slots=2, num_tasks=1)
    m = sched.metrics()
    assert m["requests"] == 0
    assert m["latency_p50_s"] == 0.0 and m["ttft_p99_s"] == 0.0
    weird = Request(rid=9, task_id=0, prompt=np.zeros(4, np.int32),
                    max_new_tokens=1, arrival=0.0)
    weird.t_done = 1.0
    sched.finished.append(weird)
    m = sched.metrics()
    assert m["requests"] == 1 and m["ttft_p50_s"] == 0.0
    assert math.isfinite(m["latency_p50_s"])


# ---------------------------------------------------------- prefix reuse


def _shared(vocab, shared, n, body, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, shared).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, body)
                            .astype(np.int32)]) for _ in range(n)]


def test_prefix_reuse_token_identical():
    """Three requests sharing a 16-token prefix: the later ones admit from
    (a clone of) the cached prefill state and emit the engine's tokens;
    the cache counters equal the reference's."""
    _, tcfg, _, tparams = _model()
    scfg = dict(max_len=64, prefix_cache=8, prefix_min=4)
    prompts = _shared(tcfg.vocab_size, 16, 3, 6)
    eng = engine(tcfg, tparams, ServeConfig(max_len=64))
    refs = [eng.generate(p[None], 5)[0] for p in prompts]
    specs = [dict(rid=i, task_id=0, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    js, ts, jb, tb = run_both("llama3_2_1b", scfg, specs, total_slots=2,
                              quantum=3, num_tasks=1, clock=True)
    done = {r.rid: r for r in ts.finished}
    for i in range(3):
        assert done[i].tokens == list(refs[i][:5]), i
    stats = tb.prefix.stats()
    assert stats["hit_tokens"] >= 16
    assert sum(r.prefix_hit_tokens for r in done.values()) \
        == stats["hit_tokens"]
    assert stats == jb.prefix.stats()
    assert_same_schedule(js, ts)


def test_prefix_exact_duplicate_prompt():
    """An exact repeat of a cached prompt still prefills >= 1 real token
    and decodes identically."""
    _, tcfg, _, tparams = _model()
    p = _shared(tcfg.vocab_size, 12, 1, 0, seed=2)[0]
    ref = engine(tcfg, tparams, ServeConfig(max_len=64)).generate(p[None],
                                                                  6)[0]
    specs = [dict(rid=i, task_id=0, prompt=p, max_new_tokens=6)
             for i in range(2)]
    js, ts, _, _ = run_both("llama3_2_1b", dict(max_len=64, prefix_cache=8,
                                                prefix_min=4), specs,
                            total_slots=1, quantum=3, num_tasks=1,
                            clock=True)
    for r in ts.finished:
        assert r.tokens == list(ref[:6]), r.rid
    assert len(p) - 1 in [r.prefix_hit_tokens for r in ts.finished]
    assert_same_schedule(js, ts)


def test_prefix_with_chunked_prefill_and_preemption():
    """The full SLO stack at once — prefix-seeded chunked admissions,
    batch-slot preemption, restore — stays token-identical and takes the
    reference's decisions."""
    _, tcfg, _, tparams = _model()
    scfg = dict(max_len=96, prefill_chunk=4, prefix_cache=8, prefix_min=4)
    prompts = _shared(tcfg.vocab_size, 16, 2, 8, seed=4)
    eng = engine(tcfg, tparams, ServeConfig(max_len=96, prefill_chunk=4))
    ref_long = eng.generate(prompts[0][None], 16)[0]
    ref_short = eng.generate(prompts[1][None], 4)[0]
    specs = [dict(rid=0, task_id=0, prompt=prompts[0], max_new_tokens=16,
                  arrival=0.0, tier="batch"),
             dict(rid=1, task_id=0, prompt=prompts[1], max_new_tokens=4,
                  arrival=0.4, tier="interactive")]
    js, ts, jb, tb = run_both(
        "llama3_2_1b", scfg, specs, total_slots=1, quantum=4, num_tasks=1,
        clock=True, slo=SLOPolicy(preemption=True, chunk_interleave=True))
    done = {r.rid: r for r in ts.finished}
    assert done[0].tokens == list(ref_long[:16])
    assert done[1].tokens == list(ref_short[:4])
    assert ts.preemptions >= 1
    assert tb.prefix.stats()["hit_tokens"] >= 4
    assert tb.prefix.stats() == jb.prefix.stats()
    assert_same_schedule(js, ts)


def test_bursty_trace_with_every_slo_feature():
    """A seeded bursty trace (shared per-tenant prefixes) through tiers,
    preemption, chunked admission and the prefix cache: the reference's
    schedule and every request's tokens, equal to the engine serving the
    request alone."""
    jcfg, tcfg, _, tparams = _model()
    tc = dict(n=12, seed=3, vocab=tcfg.vocab_size, num_tasks=1,
              mean_interarrival_s=0.02, shared_prefix_len=16,
              interactive_new=(2, 4), batch_new=(4, 8))
    specs = [{f.name: getattr(r, f.name) for f in fields(r)
              if f.name in ("rid", "task_id", "prompt", "max_new_tokens",
                            "arrival", "tier", "tenant", "ttft_slo_s",
                            "tpot_slo_s")}
             for r in TraceGenerator(TraceConfig(**tc)).generate()]
    scfg = dict(max_len=96, prefill_chunk=16, prefix_cache=8, prefix_min=8)
    js, ts, jb, tb = run_both(
        "llama3_2_1b", scfg, specs, total_slots=2, quantum=4, num_tasks=1,
        clock=True, slo=SLOPolicy(preemption=True, chunk_interleave=True))
    assert len(ts.finished) == len(specs)
    eng = engine(tcfg, tparams, ServeConfig(max_len=96))
    for r in ts.finished:
        want = eng.generate(np.asarray(r.prompt)[None], r.max_new_tokens)[0]
        assert r.tokens == list(want), r.rid
    assert_same_schedule(js, ts)
    m = ts.metrics()
    assert m["prefix_cache"]["hits"] >= 1
    assert m["preemptions"] == js.preemptions
