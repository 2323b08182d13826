"""The port's LM path — Llama-3.2-1B ``SMOKE_CONFIG`` prefill and decode —
against the JAX reference, on the CPU.

* ``ServingEngine.generate`` (prompts (2, 16), 8 new tokens, ``max_len``
  64) against the JAX ``ServingEngine`` under ``pallas_fused`` ↔
  ``cuda_fused`` and under the all-kernels pair ``pallas`` +
  ``attention_decode="pallas_fused"`` ↔ ``cuda`` +
  ``attention_decode="cuda_fused"`` (the Pallas kernels in interpret mode,
  the port's kernel modules running their plain versions): at float32 the
  greedy tokens are equal and the prefill logits agree to 1e-4 of their
  magnitude; at bf16 the prefill logits have cosine >= 0.999.  The 1e-4
  covers float32 sums taken in another order and RoPE angles whose cos/sin
  differ by an ulp between XLA and the CPU's libm.
* ``model.forward`` decoding at a (B,) vector of cache positions, and a
  windowed (ring-cache) config through prefill and decode, against the JAX
  ``models.model.forward`` from the same state: logits and every cache.
* Chunked prefill against one-shot prefill within the port.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs import llama3_2_1b as JL
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro.train.step import make_serve_step as jmake_serve_step
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get
from repro_torch.configs import llama3_2_1b as TL
from repro_torch.kernels.compare import cosine
from repro_torch.models import model as tmodel
from repro_torch.serve.engine import ServeConfig, ServingEngine

PROMPT = np.random.default_rng(1).integers(0, 128, size=(2, 16)).astype(
    np.int32)
MAX_LEN = 64
POLICIES = {  # name: (JAX policy, port policy)
    "fused": (jops.policy_named("pallas_fused"),
              ops.policy_named("cuda_fused")),
    "all_kernels": (
        jops.policy_named("pallas").with_impls(
            attention_decode="pallas_fused"),
        ops.policy_named("cuda").with_impls(attention_decode="cuda_fused")),
}
WINDOWED = dict(block_pattern=("attn_mlp", "attn_local_mlp"), window=8)


@functools.lru_cache(maxsize=None)
def _lm(dtype, windowed=False):
    over = dict(dtype=dtype, **(WINDOWED if windowed else {}))
    jcfg, tcfg = replace(JL.SMOKE_CONFIG, **over), \
        replace(TL.SMOKE_CONFIG, **over)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


@functools.lru_cache(maxsize=None)
def _jax_serve(policy, dtype):
    """The JAX engine's tokens and prefill logits."""
    jcfg, _, jparams, _ = _lm(dtype)
    jpol = POLICIES[policy][0]
    eng = jengine.ServingEngine(jcfg, jparams,
                                jengine.ServeConfig(max_len=MAX_LEN,
                                                    policy=jpol))
    tokens = np.asarray(eng.generate(jnp.asarray(PROMPT), 8))
    prefill, _ = jmake_serve_step(replace(jcfg, policy=jpol))
    logits, _ = prefill(jparams, jnp.asarray(PROMPT),
                        jmodel.init_state(jcfg, 2, MAX_LEN))
    return tokens, np.array(logits, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_generate_matches_jax_engine(policy, dtype):
    _, tcfg, _, tparams = _lm(dtype)
    want_tokens, want_logits = _jax_serve(policy, dtype)
    eng = ServingEngine(tcfg, tparams, ServeConfig(
        max_len=MAX_LEN, policy=POLICIES[policy][1]), device="cpu")
    ops.reset_dispatch_report()
    tokens = eng.generate(PROMPT, 8)
    report = ops.dispatch_report()["attention_decode"]
    assert report["hits"] == {"cuda_fused": 2 * 8}     # 2 layers x 8 steps
    assert report["fallbacks"] == []
    assert report["modes"] == {"cuda_fused": {"cpu": 16}}
    assert tokens.shape == (2, 8) and tokens.dtype == np.int32
    prefill, _ = eng.steps()
    with torch.inference_mode():
        logits, _ = prefill(eng.params, torch.from_numpy(PROMPT).long(),
                            tmodel.init_state(tcfg, 2, MAX_LEN,
                                              device="cpu"))
    logits = logits.numpy()
    assert logits.dtype == np.float32 and logits.shape == want_logits.shape
    if dtype == "float32":
        np.testing.assert_array_equal(tokens, want_tokens)
        assert np.abs(logits - want_logits).max() \
            <= 1e-4 * np.abs(want_logits).max()
    else:
        assert cosine(torch.from_numpy(logits),
                      torch.from_numpy(want_logits)) >= 0.999


def _random_state(jcfg, seed):
    """The same random KV caches as a JAX state and a port state."""
    jstate = jmodel.init_state(jcfg, 2, MAX_LEN)
    rng = np.random.default_rng(seed)
    jstate = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), jstate)
    tstate = {"layers": {b: {n: torch.from_numpy(np.array(a))
                             for n, a in c.items()}
                         for b, c in jstate["layers"].items()}}
    return jstate, tstate


def _assert_states_close(tstate, jstate):
    for b, c in jstate["layers"].items():
        for n, a in c.items():
            np.testing.assert_allclose(tstate["layers"][b][n].numpy(),
                                       np.asarray(a), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("windowed", [False, True],
                         ids=["full", "ring_window8"])
def test_forward_decodes_at_per_sequence_positions(windowed):
    """One decode step at cache_index (B,) = [5, 41] from the same random
    state: the new rows land at each sequence's own slot (slot % 8 on the
    ring) and each attends over its own live prefix."""
    jcfg, tcfg, jparams, tparams = _lm("float32", windowed)
    jstate, tstate = _random_state(jcfg, 3)
    tok = np.array([[7], [100]], np.int32)
    ci = np.array([5, 41], np.int32)
    with jops.use_policy(POLICIES["fused"][0]):
        jl, jst, _ = jmodel.forward(jparams, jnp.asarray(tok), jcfg,
                                    state=jstate, cache_index=jnp.asarray(ci),
                                    decode=True, return_state=True)
    ops.reset_dispatch_report()
    with ops.use_policy(POLICIES["fused"][1]):
        tl, tst, _ = tmodel.forward(tparams, torch.from_numpy(tok), tcfg,
                                    state=tstate,
                                    cache_index=torch.from_numpy(ci),
                                    decode=True, return_state=True)
    assert tst is tstate                       # caches written in place
    assert ops.dispatch_report()["attention_decode"]["hits"] == \
        {"cuda_fused": 2}
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= 1e-4 * np.abs(jl).max()
    _assert_states_close(tst, jst)


def test_windowed_prefill_fills_the_ring_like_jax():
    """Prefill of 20 tokens into a ring of 8 slots (rolled so token t sits
    at slot t % 8), then greedy decode, against the JAX reference."""
    jcfg, tcfg, jparams, tparams = _lm("float32", True)
    prompt = np.random.default_rng(2).integers(0, 128, size=(2, 20))
    with jops.use_policy(POLICIES["fused"][0]):
        jl, jst, _ = jmodel.forward(
            jparams, jnp.asarray(prompt, jnp.int32), jcfg,
            state=jmodel.init_state(jcfg, 2, MAX_LEN), cache_index=0,
            return_state=True)
    with ops.use_policy(POLICIES["fused"][1]):
        tl, tst, _ = tmodel.forward(
            tparams, torch.from_numpy(prompt), tcfg,
            state=tmodel.init_state(tcfg, 2, MAX_LEN, device="cpu"),
            cache_index=0, return_state=True)
    assert tst["layers"]["b1"]["k"].shape[3] == 8       # the ring
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= 1e-4 * np.abs(jl).max()
    _assert_states_close(tst, jst)
    jeng = jengine.ServingEngine(jcfg, jparams, jengine.ServeConfig(
        max_len=MAX_LEN, policy=POLICIES["fused"][0]))
    teng = ServingEngine(tcfg, tparams, ServeConfig(
        max_len=MAX_LEN, policy=POLICIES["fused"][1]), device="cpu")
    np.testing.assert_array_equal(
        teng.generate(prompt, 6),
        np.asarray(jeng.generate(jnp.asarray(prompt, jnp.int32), 6)))


@pytest.mark.parametrize("offset", [0, 37, "vector"])
def test_positions_match_jax(offset):
    """RoPE at decode-range positions and the sinusoidal table, float32:
    within 2e-6 (cos/sin of float32 angles may differ by an ulp between
    XLA and the CPU's libm)."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    off = np.array([3, 500], np.int32) if offset == "vector" else offset
    pos = np.arange(5)[None, :] + (np.asarray(off)[:, None]
                                   if offset == "vector" else off)
    pos = np.broadcast_to(pos, (2, 5)).astype(np.int32)
    x = np.random.default_rng(5).normal(size=(2, 3, 5, 16)).astype(
        np.float32)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         500000.0))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             500000.0).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    want = np.asarray(jlayers.sincos_positions(5, 16, jnp.asarray(off)))
    got = tlayers.sincos_positions(5, 16, torch.as_tensor(off)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_untied_head_forward_matches_jax():
    """An untied LM head (``head.w`` through the unified linear op) and the
    bridge carrying it, prefill logits at float32."""
    jcfg = replace(JL.SMOKE_CONFIG, dtype="float32", tie_embeddings=False)
    tcfg = replace(TL.SMOKE_CONFIG, dtype="float32", tie_embeddings=False)
    jparams = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    assert tparams["head.w"].shape == (64, 128)
    want, _, _ = jmodel.forward(jparams, jnp.asarray(PROMPT), jcfg)
    got, _, _ = tmodel.forward(tparams, torch.from_numpy(PROMPT), tcfg)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("s0", [16, 13], ids=["whole_chunks", "padded"])
def test_chunked_prefill_matches_one_shot(s0):
    _, tcfg, _, tparams = _lm("float32")
    prompt = PROMPT[:, :s0]
    pol = POLICIES["fused"][1]
    one = ServingEngine(tcfg, tparams, ServeConfig(max_len=MAX_LEN,
                                                   policy=pol), device="cpu")
    chunked = ServingEngine(tcfg, tparams, ServeConfig(
        max_len=MAX_LEN, policy=pol, prefill_chunk=8), device="cpu")
    np.testing.assert_array_equal(chunked.generate(prompt, 8),
                                  one.generate(prompt, 8))
    with torch.inference_mode():
        p = torch.from_numpy(prompt).long()
        want, _ = one._prefill(p, tmodel.init_state(tcfg, 2, MAX_LEN,
                                                    device="cpu"), 0)
        got, _ = chunked._prefill(p, tmodel.init_state(tcfg, 2, MAX_LEN,
                                                       device="cpu"), 0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_eos_and_temperature_sampling():
    _, tcfg, _, tparams = _lm("float32")
    greedy = ServingEngine(tcfg, tparams, ServeConfig(max_len=MAX_LEN),
                           device="cpu").generate(PROMPT, 8)
    eos = int(greedy[0, 2])
    stopped = ServingEngine(tcfg, tparams, ServeConfig(
        max_len=MAX_LEN, eos_id=eos), device="cpu").generate(PROMPT, 8)
    first = int(np.argmax(greedy[0] == eos))
    np.testing.assert_array_equal(stopped[0, :first + 1],
                                  greedy[0, :first + 1])
    assert (stopped[0, first:] == eos).all()
    hot = ServingEngine(tcfg, tparams, ServeConfig(
        max_len=MAX_LEN, temperature=1.0, seed=5), device="cpu")
    a = hot.generate(PROMPT, 8)
    np.testing.assert_array_equal(a, hot.generate(PROMPT, 8))
    g = torch.Generator().manual_seed(5)
    np.testing.assert_array_equal(a, hot.generate(PROMPT, 8, generator=g))
    assert ((a >= 0) & (a < tcfg.vocab_size)).all()


@pytest.mark.parametrize("over", [
    dict(scfg=dict(kv_quant="int8")), dict(scfg=dict(async_paging=True)),
    dict(scfg=dict(prefix_cache=4)), dict(rules=object()),
    dict(cfg=dict(block_pattern=("rglru_mlp",))),
    dict(cfg=dict(embed_input="embeddings"))],
    ids=["kv_int8", "async_paging", "prefix_cache", "mesh", "recurrent",
         "embeddings"])
def test_later_slices_raise(over):
    _, tcfg, _, tparams = _lm("float32")
    cfg = replace(tcfg, **over.get("cfg", {}))
    with pytest.raises(NotImplementedError, match="slice of the port"):
        ServingEngine(cfg, tparams, ServeConfig(**over.get("scfg", {})),
                      rules=over.get("rules"), device="cpu")


def test_config_fields_and_lookup():
    cfg = get("llama3_2_1b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.hd, cfg.d_ff, cfg.vocab_size) == \
        (16, 2048, 32, 8, 64, 8192, 128256)
    assert cfg.rope_theta == 500000.0 and cfg.tie_embeddings
    assert cfg.kv_quant == "none" and cfg.remat and not cfg.sub_quadratic
    smoke = get("llama3_2-1b", smoke=True)
    assert smoke == TL.SMOKE_CONFIG and not smoke.remat
    for name in ("rope_theta", "tie_embeddings", "kv_quant", "remat",
                 "sub_quadratic"):
        assert getattr(cfg, name) == getattr(JL.CONFIG, name)


def test_engine_and_model_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is usable")
    _, tcfg, _, tparams = _lm("float32")
    for call in (lambda: ServingEngine(tcfg, tparams, ServeConfig()),
                 lambda: tmodel.init_params(0, tcfg),
                 lambda: tmodel.init_state(tcfg, 1, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_port_init_params_has_the_reference_tree():
    _, tcfg, jparams, tparams = _lm("float32")
    mine = tmodel.init_params(0, tcfg, device="cpu")
    assert set(mine) == set(tparams)
    for name, t in tparams.items():
        assert mine[name].shape == t.shape and mine[name].dtype == t.dtype
    untied = replace(tcfg, tie_embeddings=False)
    assert tmodel.init_params(0, untied, device="cpu")["head.w"].shape == \
        (tcfg.d_model, tcfg.vocab_size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_head_in_row_chunks_matches_jax(dtype, monkeypatch):
    """The tied head widens the table to float32 a few rows at a time: with
    chunks of 48 rows over a vocab of 128 (two whole chunks and a ragged
    one) the prefill logits match the JAX forward's float32 logits."""
    from repro_torch.models import layers as tlayers

    jcfg, tcfg, jparams, tparams = _lm(dtype)
    monkeypatch.setattr(tlayers, "_HEAD_ROWS", 48)
    want, _, _ = jmodel.forward(jparams, jnp.asarray(PROMPT), jcfg)
    got, _, _ = tmodel.forward(tparams, torch.from_numpy(PROMPT), tcfg)
    want = np.array(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dtype == "float32":
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    else:
        assert cosine(got, torch.from_numpy(want)) >= 0.999


def test_decode_flag_and_per_sequence_prefill_raise():
    """``decode=True`` is a one-token step, and a prefill at a (B,) vector
    of offsets waits for the scheduler slice."""
    _, tcfg, _, tparams = _lm("float32")
    state = tmodel.init_state(tcfg, 2, MAX_LEN, device="cpu")
    two = torch.from_numpy(PROMPT[:, :2]).long()
    with pytest.raises(ValueError, match="one-token step"):
        tmodel.forward(tparams, two, tcfg, state=state, cache_index=4,
                       decode=True)
    with pytest.raises(NotImplementedError, match="scheduler slice"):
        tmodel.forward(tparams, two, tcfg, state=state,
                       cache_index=torch.tensor([3, 9]))
