"""The six remaining decoder configurations, the stub frontends, M³ViT-many
and Llama-4-Scout's MoE layer against the JAX reference, on the CPU, from
the same NumPy inputs and the reference's parameters through ``bridge``.

The reference draws the stub frontends' pseudo-embedding table with
``jax.random``; the port draws its own (``serve.engine._stub_embed_table``).
The port's engines and backends here are given the reference's table
(``bridge.stub_table_from_jax``), so both feed back the same rows.

Tolerances (float32, the exact presets: ``xla`` beside ``eager``):

* forward logits of each ``SMOKE_CONFIG`` (MusicGen-Large, Qwen2-VL-72B,
  Phi-4-mini, Qwen1.5-4B, DeepSeek-67B, Llama-4-Scout): max |diff| <=
  1e-5 × the largest |logit|; then one decode step after a prefill (for
  the stub frontends an embedding row fed back through
  ``feedback_inputs``), the same bound;
* ``ServingEngine.generate`` for MusicGen and Qwen2-VL: the reference
  engine's tokens, exactly;
* the ``Scheduler`` with embedding prompts (padded, several lengths, fewer
  slots than requests, chunked admissions beside live slots): every
  request's tokens equal the static engine's, exactly;
* M³ViT-many's ``SMOKE_CONFIG`` (256 experts, 8 tasks): the forward of
  both tasks within 1e-4 × the output's max magnitude (the bound of
  ``test_torch_m3vit.py``'s exact-activation comparison);
* Llama-4-Scout's MoE layer (16 experts, top-1, no renormalisation, one
  shared expert; ``onehot`` and ``grouped``): output within 1e-5 × its
  max magnitude, the aux loss within 1e-5 relative, the dispatch counts
  equal; in bf16 cosine >= 0.999.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import ops as jops
from repro.core import moe as JMOE
from repro.models import model as jmodel
from repro.models import transformer as JT
from repro.models import vit as jvit
from repro.serve import engine as jengine
from repro.train.step import make_serve_step as jmake_serve_step
from repro_torch import configs as tconfigs
from repro_torch import ops
from repro_torch.bridge import (params_from_jax, stub_table_from_jax,
                                tensor_from_numpy)
from repro_torch.core import moe as TMOE
from repro_torch.kernels.compare import cosine
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as TT
from repro_torch.models import vit as tvit
from repro_torch.serve import LMBackend, Request, Scheduler
from repro_torch.serve.engine import (ServeConfig, ServingEngine,
                                      feedback_inputs, stub_feedback_table)
from repro_torch.train.step import make_serve_step
from test_torch_threads import one_torch_thread  # noqa: F401

LMS = ("musicgen_large", "qwen2_vl_72b", "phi4_mini_3_8b", "qwen1_5_4b",
       "deepseek_67b", "llama4_scout_17b_a16e")
FRONTENDS = ("musicgen_large", "qwen2_vl_72b")
EXACT = (jops.policy_named("xla"), ops.policy_named("eager"))
LOGIT_TOL = 1e-5
B, S, MAX_LEN, NEW = 2, 12, 48, 6


@functools.lru_cache(maxsize=None)
def _table(arch):
    """The reference's stub table of a frontend (at float32), carried
    across; None for a token-input arch."""
    cfg = _cfgs(arch)[0]
    if cfg.embed_input == "tokens":
        return None
    return stub_table_from_jax(jengine._stub_embed_table(
        cfg.vocab_size, cfg.d_model, cfg.dtype))


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    jcfg = replace(jconfigs.get(arch, smoke=True), dtype="float32",
                   policy=EXACT[0])
    tcfg = replace(tconfigs.get(arch, smoke=True), dtype="float32",
                   policy=EXACT[1])
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams),
                                                device="cpu")


def _inputs(cfg, b=B, s=S, seed=3):
    rng = np.random.default_rng(seed)
    if cfg.embed_input == "tokens":
        return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _tensor(a):
    t = torch.from_numpy(a)
    return t.long() if t.dtype == torch.int32 else t


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


@pytest.mark.parametrize("arch", LMS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    x = _inputs(tcfg)
    want = jax.jit(functools.partial(jmodel.forward, cfg=jcfg))(
        jparams, jnp.asarray(x))[0]
    with torch.inference_mode():
        got, _, _ = tmodel.forward(tparams, _tensor(x), tcfg)
    assert got.shape == (B, S, tcfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("arch", LMS)
def test_prefill_then_decode_matches_reference(arch):
    """A prefill of S positions, then one decode step whose input is the
    greedy token (an embedding row of the reference's table for a stub
    frontend, through each package's ``feedback_inputs``)."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    x = _inputs(tcfg)
    jprefill, jdecode = jmake_serve_step(jcfg)
    prefill, decode = make_serve_step(tcfg)
    jl, jstate = jprefill(jparams, jnp.asarray(x),
                          jmodel.init_state(jcfg, B, MAX_LEN))
    with torch.inference_mode():
        tl, tstate = prefill(tparams, _tensor(x),
                             tmodel.init_state(tcfg, B, MAX_LEN, device="cpu"))
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        feed = feedback_inputs(tcfg, torch.from_numpy(tok),
                               stub_feedback_table(tcfg, "cpu", _table(arch)))
        jfeed = jengine.feedback_inputs(jcfg, jnp.asarray(tok))
        np.testing.assert_array_equal(feed.numpy(), np.asarray(jfeed))
        assert feed.shape == ((B, 1) if tcfg.embed_input == "tokens"
                              else (B, 1, tcfg.d_model))
        jl, _ = jdecode(jparams, jfeed, jstate, jnp.int32(S))
        tl, _ = decode(tparams, feed, tstate, S)
    _close(tl, jl)


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch):
    jcfg, tcfg, jparams, _ = _model(arch)
    eng = jengine.ServingEngine(jcfg, jparams,
                                jengine.ServeConfig(max_len=MAX_LEN))
    return np.asarray(eng.generate(jnp.asarray(_inputs(tcfg)), NEW))


@pytest.mark.parametrize("arch", FRONTENDS)
def test_generate_matches_reference_engine(arch):
    _, tcfg, _, tparams = _model(arch)
    eng = ServingEngine(tcfg, tparams, ServeConfig(max_len=MAX_LEN),
                        device="cpu", stub_table=_table(arch))
    got = eng.generate(_inputs(tcfg), NEW)
    np.testing.assert_array_equal(got, _jax_tokens(arch))
    assert torch.equal(eng.fb_table, _table(arch))    # one copy, kept
    with pytest.raises(ValueError, match="stub table"):
        feedback_inputs(tcfg, torch.zeros(2, dtype=torch.long))
    np.testing.assert_array_equal(
        eng.generate(torch.from_numpy(_inputs(tcfg)), NEW), got)


@pytest.mark.parametrize("chunked", [False, True], ids=["one_shot",
                                                        "chunk_interleave"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_scheduler_embedding_prompts_equal_static_engine(arch, chunked):
    """Five requests of 5..21 embedding rows in 2 slots (prompts padded to
    multiples of 16 with zero rows); with ``chunk_interleave`` the long
    prompts admit in 8-row chunks beside decoding slots."""
    from repro_torch.serve.slo import SLOPolicy

    _, tcfg, _, tparams = _model(arch)
    scfg = ServeConfig(max_len=MAX_LEN, prefill_chunk=8 if chunked else 0,
                       prefix_cache=4)
    rng = np.random.default_rng(11)
    lengths, news = [5, 21, 16, 9, 17], [4, 7, 3, 6, 5]
    prompts = [rng.standard_normal((n, tcfg.d_model)).astype(np.float32)
               for n in lengths]
    eng = ServingEngine(tcfg, tparams, scfg, device="cpu",
                        stub_table=_table(arch))
    want = [eng.generate(p[None], m)[0].tolist()
            for p, m in zip(prompts, news)]
    backend = LMBackend(tcfg, tparams, scfg, device="cpu",
                        stub_table=_table(arch))
    slo = SLOPolicy(preemption=False, chunk_interleave=True) if chunked \
        else None
    sched = Scheduler(backend, total_slots=2, quantum=2, num_tasks=1,
                      slo=slo)
    done = sched.run([Request(rid=i, task_id=0, prompt=p, max_new_tokens=m)
                      for i, (p, m) in enumerate(zip(prompts, news))])
    assert sorted(r.rid for r in done) == list(range(5))
    for r in done:
        assert r.tokens == want[r.rid], r.rid
    assert backend.prefix.stats()["lookups"] == 0   # token prompts only
    bucket = sched.buckets[None]
    assert (bucket.prefill_chunks > 0) == chunked


@functools.lru_cache(maxsize=None)
def _m3vit_many():
    jcfg = replace(jconfigs.get("m3vit_many", smoke=True), dtype="float32")
    tcfg = replace(tconfigs.get("m3vit_many", smoke=True), dtype="float32")
    jparams = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams),
                                                device="cpu")


@pytest.mark.parametrize("task", ["semseg", "depth"])
def test_m3vit_many_forward_matches_reference(task):
    jcfg, tcfg, jparams, tparams = _m3vit_many()
    assert tcfg.moe.num_experts == 256 and tcfg.num_tasks == 8
    img = np.random.default_rng(1).normal(
        size=(2, 128, 256, 3)).astype(np.float32)
    with jops.use_policy(EXACT[0]):
        want, _ = jvit.forward(jparams, jnp.asarray(img), jcfg, task=task)
    with ops.use_policy(EXACT[1]):
        got, _ = tvit.forward(tparams, torch.from_numpy(img), tcfg,
                              task=task)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def _scout_moe(impl, dtype):
    """Llama-4-Scout's MoE spec at the smoke width, its 16 experts kept."""
    spec = replace(jconfigs.get("llama4_scout_17b_a16e", smoke=True).moe,
                   num_experts=16, impl=impl)
    jcfg = replace(jconfigs.get("llama4_scout_17b_a16e", smoke=True),
                   moe=spec, dtype=dtype)
    tcfg = replace(tconfigs.get("llama4_scout_17b_a16e", smoke=True),
                   moe=replace(tconfigs.get("llama4_scout_17b_a16e").moe,
                               **{k: getattr(spec, k) for k in (
                                   "num_experts", "impl", "d_ff",
                                   "group_size", "capacity_factor")}),
                   dtype=dtype)
    return JT.moe_config(jcfg), TT.moe_config(tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["onehot", "grouped"])
def test_scout_moe_layer_matches_reference(impl, dtype):
    jm, tm = _scout_moe(impl, dtype)
    assert (tm.top_k, tm.renormalize, tm.num_shared_experts,
            tm.num_experts) == (1, False, 1, 16) and tm == replace(
        tm, **{f: getattr(jm, f) for f in jm.__dataclass_fields__})
    jp = JMOE.init_moe(jax.random.PRNGKey(2), jm, jnp.dtype(dtype))
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(6).standard_normal(
        (3, 40, jm.d_model)).astype(np.float32)
    with jops.use_policy(EXACT[0]):
        jy, jaux, jcounts = JMOE.apply_moe(
            jp, jm, jnp.asarray(x).astype(dtype), return_stats=True)
    with ops.use_policy(EXACT[1]):
        ty, taux, tcounts = TMOE.apply_moe(
            tp, tm, torch.from_numpy(x).to(getattr(torch, dtype)),
            return_stats=True)
    want = torch.from_numpy(np.array(jy, np.float32))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    if dtype == "bfloat16":
        assert cosine(ty.float(), want) >= 0.999
        return
    assert (ty - want).abs().max() <= 1e-5 * want.abs().max()


def test_scout_dispatch_routes():
    """Under ``cuda`` the experts dispatch ``moe_grouped_gemm`` to the
    kernel impl (its plain version on CPU tensors); with ``moe_ffn`` on
    ``cuda_fused`` the routed layer records a fallback to the staged path
    (its GEMMs still on ``cuda``) with the reference's reason for
    ``onehot``."""
    _, tm = _scout_moe("onehot", "bfloat16")
    tp = TMOE.init_moe(np.random.default_rng(0), tm)
    x = torch.randn((1, 8, tm.d_model)).to(torch.bfloat16)
    cuda = ops.policy_named("cuda")
    for name, policy in (("cuda", cuda),
                         ("cuda_fused", cuda.with_impls(moe_ffn="cuda_fused"))):
        ops.reset_dispatch_report()
        with ops.use_policy(policy):
            TMOE.apply_moe(tp, tm, x)
        rep = ops.dispatch_report()
        assert rep["moe_grouped_gemm"]["hits"] == {"cuda": 3}
        assert rep["moe_grouped_gemm"]["modes"] == {"cuda": {"cpu": 3}}
        falls = rep["moe_ffn"]["fallbacks"]
        if name == "cuda_fused":
            assert falls[0]["used"] == "eager"
            assert "onehot" in falls[0]["reasons"][0]
