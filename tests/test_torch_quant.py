"""Packed weights in the port (``repro_torch.quant``, the ``eager_int8``
impls, the int8 KV cache) against the JAX reference (``repro.quant``,
``xla_int8``), on the CPU.

* ``quantize`` / ``quantize_kv`` give ``q``, ``scale`` and ``rows`` equal
  to the reference's bit for bit — int8 and int4, float32 and bfloat16
  inputs, odd rows, zero channels — and reject non-finite input as it
  does; ``dequantize`` is bit-equal too.  ``quantize_tree`` converts the
  same dotted names, ``tree_bytes`` agrees, and the bridge rebuilds the
  reference's QTensors as the port's.
* ``eager_int8`` against ``xla_int8`` for ``linear``, ``moe_grouped_gemm``
  and ``attention_decode``: within ``kernels/compare.py``'s float32
  tolerance.  Every floating-point and kernel impl rejects a packed
  operand with the reference's reason (the port's impl names), a recorded
  fallback.
* M³ViT ``SMOKE_CONFIG`` at float32 under int8 and int4 against the
  reference's ``xla_int8`` forward for both tasks, within ``LUT_BOUND`` ×
  the output's max magnitude (``tests/test_torch_m3vit.py``: both sides
  run LUT activations); int8 holds cosine >= 0.999 against the
  unquantized forward, the reference's bar (``tests/test_quant.py``).
* Llama ``SMOKE_CONFIG`` with an int8 KV cache gives the JAX engine's
  tokens, and a chunked prefill gives the one-shot run's.
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
from repro.configs import m3vit as JM
from repro.models import model as jmodel
from repro.models import vit as jvit
from repro.quant import dequantize as jdequantize
from repro.quant import quantize as jquantize
from repro.quant import quantize_kv as jquantize_kv
from repro.quant import quantize_tree as jquantize_tree
from repro.quant import tree_bytes as jtree_bytes
from repro.serve import engine as jengine
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.configs import llama3_2_1b as TL
from repro_torch.configs import m3vit as TM
from repro_torch.kernels.compare import cosine, within_tolerance
from repro_torch.models import vit
from repro_torch.quant import (QTensor, dequantize, dequantize_tree,
                               is_qtensor, quantize, quantize_kv,
                               quantize_tree, tree_bytes)
from repro_torch.serve.engine import ServeConfig, ServingEngine
from test_torch_threads import one_torch_thread  # noqa: F401

LUT_BOUND = 5e-4        # tests/test_torch_m3vit.py
F32 = torch.float32


def _w(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _pair(w, dtype):
    """The same weight as a JAX array and a port tensor of ``dtype``."""
    j = jnp.asarray(w, dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _assert_same_qtensor(jq, tq):
    assert tq.bits == jq.bits and tq.rows == jq.rows and tq.dtype == jq.dtype
    assert tq.shape == tuple(jq.shape)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.q.dtype == (torch.int8 if jq.bits == 8 else torch.uint8)


# ================================================================ quantize


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,group", [(8, 32), (4, 32), (4, 8), (4, 3)])
@pytest.mark.parametrize("shape", [(64, 32), (37, 8), (1, 5), (5, 24, 16),
                                   (2, 3, 33, 7)])
def test_quantize_bit_equal(shape, bits, group, dtype):
    jw, tw = _pair(_w(shape, seed=len(shape) * 7 + shape[-1]), dtype)
    jq = jquantize(jw, bits, group_size=group)
    tq = quantize(tw, bits, group_size=group)
    _assert_same_qtensor(jq, tq)
    for out in ("float32", "bfloat16"):
        want = np.asarray(jdequantize(jq, getattr(jnp, out)).astype(
            jnp.float32))
        got = dequantize(tq, getattr(torch, out)).float().numpy()
        np.testing.assert_array_equal(got, want)
    assert tq.nbytes == jq.nbytes


@pytest.mark.parametrize("bits", [8, 4])
def test_zero_channel_and_extremes(bits):
    w = _w((16, 8), seed=3)
    w[:, 3] = 0.0
    w[0, 0], w[1, 1] = 3e37, 1e-30
    jq, tq = jquantize(jnp.asarray(w), bits), quantize(torch.from_numpy(w),
                                                       bits)
    _assert_same_qtensor(jq, tq)
    assert (tq.scale > 0).all()
    np.testing.assert_array_equal(dequantize(tq, F32)[:, 3].numpy(), 0.0)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("bits", [8, 4])
def test_nonfinite_rejected(bad, bits):
    w = _w((8, 8), seed=1)
    w[2, 2] = bad
    with pytest.raises(ValueError):
        jquantize(jnp.asarray(w), bits)
    with pytest.raises(ValueError, match="NaN/Inf"):
        quantize(torch.from_numpy(w), bits)


def test_bad_args_rejected():
    with pytest.raises(ValueError):
        quantize(torch.zeros(8), 8)
    with pytest.raises(ValueError):
        quantize(torch.zeros(8, 8), 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 8, 64])
def test_quantize_kv_bit_equal(d, dtype):
    x = _w((2, 3, 5, d), seed=d, scale=4.0)
    x[0, 0, 1] = 0.0                           # an all-zero row
    jx, tx = _pair(x, dtype)
    jq, js = jquantize_kv(jx)
    tq, ts = quantize_kv(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.shape == x.shape[:-1] + (1,)
    np.testing.assert_array_equal((tq[0, 0, 1].float() * ts[0, 0, 1])
                                  .numpy(), 0.0)


def test_qtensor_indexing_and_device():
    tq = quantize(torch.from_numpy(_w((3, 4, 16, 8))), 4, group_size=8)
    one = tq[1]
    assert one.shape == (4, 16, 8) and one.bits == 4 and one.rows == 16
    np.testing.assert_array_equal(dequantize(one, F32).numpy(),
                                  dequantize(tq, F32)[1].numpy())
    moved = tq.to("cpu")
    assert moved.q.device.type == moved.scale.device.type == "cpu"
    with pytest.raises(IndexError):
        quantize(torch.ones(4, 4), 8)[0]


# ==================================================================== trees


def _ref_tree():
    rng = np.random.default_rng(0)

    def a(*s):
        return jnp.asarray(rng.normal(size=s), jnp.float32)
    return {"attn": {"wq": a(8, 8), "bq": jnp.zeros((8,), jnp.float32)},
            "moe": {"w1": a(4, 8, 8), "b1": jnp.zeros((4, 8), jnp.float32),
                    "gate": a(2, 8, 4)},
            "embed": {"tokens": a(16, 8)},
            "layers": {"b0": {"mlp": {"w2": a(3, 8, 8)}}},
            "rest": [{"w": a(8, 8)}]}


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_matches_reference(bits):
    jtree = _ref_tree()
    jq = jquantize_tree(jtree, bits=bits)
    flat = params_from_jax(jax.device_get(jtree), device="cpu")
    tq = quantize_tree(flat, bits=bits)
    want = {k for k, v in params_from_jax(jax.device_get(jq),
                                          device="cpu").items()
            if is_qtensor(v)}
    assert {k for k, v in tq.items() if is_qtensor(v)} == want == {
        "attn.wq", "moe.w1", "layers.b0.mlp.w2", "rest.0.w"}
    assert tree_bytes(tq) == jtree_bytes(jq)
    # the bridge rebuilds the reference's QTensors bit for bit
    bridged = params_from_jax(jax.device_get(jq), device="cpu")
    for name in want:
        assert isinstance(bridged[name], QTensor)
        _assert_same_qtensor(jq_leaf(jq, name), tq[name])
        np.testing.assert_array_equal(bridged[name].q.numpy(),
                                      tq[name].q.numpy())
    # idempotent, and the nested form converts the same leaves
    assert quantize_tree(tq)["attn.wq"] is tq["attn.wq"]
    nested = quantize_tree({"attn": {"wq": flat["attn.wq"]}}, bits=bits)
    np.testing.assert_array_equal(nested["attn"]["wq"].q.numpy(),
                                  tq["attn.wq"].q.numpy())
    deq = dequantize_tree(tq)
    assert deq["attn.wq"].dtype == F32 and deq["attn.wq"].shape == (8, 8)


def jq_leaf(tree, dotted):
    node = tree
    for part in dotted.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


# ============================================================ eager_int8


def _jdispatch(op, *args, **kw):
    with jops.use_policy(jops.policy_named("xla_int8")):
        return np.array(jops.dispatch(op, *args, **kw), np.float32)


def _tdispatch(op, *args, policy="eager_int8", **kw):
    with ops.use_policy(ops.policy_named(policy)):
        return ops.dispatch(op, *args, **kw)


@pytest.mark.parametrize("act", [None, "gelu", "silu"])
@pytest.mark.parametrize("bits", [8, 4])
def test_linear_int8_matches_reference(bits, act):
    x, w, b = _w((3, 7, 48), 1), _w((48, 40), 2, 0.2), _w((40,), 3)
    jq = jquantize(jnp.asarray(w), bits, group_size=16)
    tq = quantize(torch.from_numpy(w), bits, group_size=16)
    want = _jdispatch("linear", jnp.asarray(x), jq, jnp.asarray(b),
                      activation=act)
    ops.reset_dispatch_report()
    got = _tdispatch("linear", torch.from_numpy(x), tq, torch.from_numpy(b),
                     activation=act)
    assert within_tolerance(got, torch.from_numpy(want), F32)
    rep = ops.dispatch_report()["linear"]
    assert rep["hits"] == {"eager_int8": 1} and not rep["fallbacks"]


@pytest.mark.parametrize("bits", [8, 4])
def test_moe_grouped_gemm_int8_matches_reference(bits):
    e, c, d, f = 6, 12, 32, 24
    buf, w = _w((e, c, d), 4), _w((e, d, f), 5, 0.3)
    sizes = np.array([12, 0, 5, 1, 12, 7], np.int32)
    jq = jquantize(jnp.asarray(w), bits)
    tq = quantize(torch.from_numpy(w), bits)
    want = _jdispatch("moe_grouped_gemm", jnp.asarray(buf), jq,
                      jnp.asarray(sizes))
    # the port carries a leading routing-group axis: one group here
    got = _tdispatch("moe_grouped_gemm", torch.from_numpy(buf)[None], tq,
                     torch.from_numpy(sizes)[None])[0]
    assert got.dtype == F32
    assert within_tolerance(got, torch.from_numpy(want), F32)
    assert (got[1] == 0).all() and (got[3, 1:] == 0).all()


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_int8_matches_reference(dtype, window):
    b, hq, hkv, smax, d = 3, 4, 2, 16, 8
    q = _w((b, hq, 1, d), 6)
    k, v = _w((b, hkv, smax, d), 7), _w((b, hkv, smax, d), 8)
    lens = np.array([16, 9, 1], np.int32)
    jq_, tq_ = _pair(q, dtype)
    jk, tk = quantize_kv(torch.from_numpy(k)), quantize_kv(
        torch.from_numpy(k))
    tv = quantize_kv(torch.from_numpy(v))
    from repro.quant import QTensor as JQ

    jkc = JQ(jnp.asarray(jk[0].numpy()), jnp.asarray(jk[1].numpy()),
             dtype=dtype)
    jvc = JQ(jnp.asarray(tv[0].numpy()), jnp.asarray(tv[1].numpy()),
             dtype=dtype)
    want = _jdispatch("attention_decode", jq_, jkc, jvc, jnp.asarray(lens),
                      window=window)
    got = _tdispatch("attention_decode", tq_,
                     QTensor(*tk, dtype=dtype), QTensor(*tv, dtype=dtype),
                     torch.from_numpy(lens), window=window)
    assert within_tolerance(got.float(), torch.from_numpy(want),
                            getattr(torch, dtype))


REJECT = "operand is quantized (QTensor) — served by the eager_int8 impl"


@pytest.mark.parametrize("policy", ["eager", "cuda", "ref"])
def test_packed_operands_fall_back_with_reason(policy):
    """A QTensor sent to a floating-point or kernel impl is a recorded
    fallback to eager_int8 with the reference's reason, never a crash."""
    x, w = torch.from_numpy(_w((4, 16), 1)), quantize(
        torch.from_numpy(_w((16, 8), 2)), 8)
    buf = torch.from_numpy(_w((1, 3, 4, 16), 3))
    wm = quantize(torch.from_numpy(_w((3, 16, 8), 4)), 8)
    sizes = torch.tensor([[4, 2, 0]], dtype=torch.int32)
    q = torch.from_numpy(_w((1, 2, 1, 8), 5))
    kc = QTensor(*quantize_kv(torch.from_numpy(_w((1, 2, 6, 8), 6))))
    ops.reset_dispatch_report()
    with ops.use_policy(ops.policy_named(policy)):
        ops.dispatch("linear", x, w)
        ops.dispatch("moe_grouped_gemm", buf, wm, sizes)
        ops.dispatch("attention_decode", q, kc, kc,
                     torch.tensor([6], dtype=torch.int32))
    rep = ops.dispatch_report()
    for op in ("linear", "moe_grouped_gemm", "attention_decode"):
        (fb,) = rep[op]["fallbacks"]
        assert fb["used"] == "eager_int8", (op, fb)
        assert fb["reasons"][0] == f"{policy}: {REJECT}", (op, fb)


def test_fused_moe_rejects_packed_experts():
    from repro_torch.core.moe import MoEConfig, apply_moe, init_moe

    cfg = MoEConfig(d_model=16, d_ff=24, num_experts=4, top_k=2,
                    num_tasks=2, expert_kind="gelu", group_size=16)
    p = quantize_tree(init_moe(np.random.default_rng(0), cfg, torch.float32))
    x = torch.from_numpy(_w((2, 16, 16), 1))
    ops.reset_dispatch_report()
    with ops.use_policy(ops.policy_named("eager_int8").with_impls(
            moe_ffn="cuda_fused")):
        apply_moe(p, cfg, x, task_id=1)
    (fb,) = ops.dispatch_report()["moe_ffn"]["fallbacks"]
    assert fb["used"] == "eager" and fb["reasons"] == [
        "cuda_fused: expert weights are quantized (QTensor) — staged path "
        "serves them via the eager_int8 grouped GEMM"]


# ================================================================ M3ViT


@functools.lru_cache(maxsize=None)
def _m3vit(bits):
    jcfg = replace(JM.SMOKE_CONFIG, dtype="float32",
                   policy=jops.policy_named("xla_int8"))
    tcfg = replace(TM.SMOKE_CONFIG, dtype="float32",
                   policy=ops.policy_named("eager_int8"))
    jparams = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return (jcfg, tcfg, jquantize_tree(jparams, bits=bits),
            quantize_tree(tparams, bits=bits), tparams)


def _images(b=2, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, TM.IMAGE_H, TM.IMAGE_W, 3)).astype(np.float32)


@pytest.mark.parametrize("task", ["semseg", "depth"])
@pytest.mark.parametrize("bits", [8, 4])
def test_m3vit_quantized_forward_matches_reference(bits, task):
    jcfg, tcfg, jq, tq, tparams = _m3vit(bits)
    img = _images()
    want = np.asarray(jvit.forward(jq, jnp.asarray(img), jcfg, task)[0])
    ops.reset_dispatch_report()
    with torch.inference_mode():
        got = vit.forward(tq, torch.from_numpy(img), tcfg, task)[0].numpy()
    rep = ops.dispatch_report()
    for op in ("linear", "moe_grouped_gemm"):
        assert rep[op]["hits"].get("eager_int8", 0) >= 1, (op, rep[op])
        assert not rep[op]["fallbacks"], (op, rep[op])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LUT_BOUND * np.abs(want).max()
    if bits == 8:
        with torch.inference_mode():
            fp = vit.forward(tparams, torch.from_numpy(img), replace(
                tcfg, policy=ops.policy_named("eager")), task)[0]
        assert cosine(torch.from_numpy(got), fp) >= 0.999


def test_m3vit_expert_bytes_shrink():
    _, _, _, tq8, tparams = _m3vit(8)
    tq4 = _m3vit(4)[3]
    names = [k for k in tparams if ".moe.w" in k]
    fp = tree_bytes({k: tparams[k] for k in names})
    assert fp / tree_bytes({k: tq8[k] for k in names}) >= 3.5
    assert fp / tree_bytes({k: tq4[k] for k in names}) >= 6.0


# ============================================================ int8 KV cache


@functools.lru_cache(maxsize=None)
def _llama():
    jcfg = replace(JL.SMOKE_CONFIG, dtype="float32")
    tcfg = replace(TL.SMOKE_CONFIG, dtype="float32")
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams),
                                                device="cpu")


PROMPTS = np.random.default_rng(2).integers(0, 128, (2, 11)).astype(np.int32)


@pytest.mark.parametrize("weights", ["float", "int8"])
def test_int8_kv_engine_matches_jax(weights):
    jcfg, tcfg, jparams, tparams = _llama()
    if weights == "int8":
        jparams, tparams = jquantize_tree(jparams), quantize_tree(tparams)
    jeng = jengine.ServingEngine(jcfg, jparams, jengine.ServeConfig(
        max_len=32, kv_quant="int8", policy=jops.policy_named("xla_int8")))
    want = np.asarray(jeng.generate(jnp.asarray(PROMPTS), 6))
    ops.reset_dispatch_report()
    teng = ServingEngine(tcfg, tparams, ServeConfig(
        max_len=32, kv_quant="int8", policy=ops.policy_named("eager_int8")),
        device="cpu")
    np.testing.assert_array_equal(teng.generate(PROMPTS, 6), want)
    rep = ops.dispatch_report()["attention_decode"]
    assert rep["hits"] == {"eager_int8": 2 * 6} and not rep["fallbacks"]
    chunked = ServingEngine(tcfg, tparams, ServeConfig(
        max_len=32, kv_quant="int8", prefill_chunk=4,
        policy=ops.policy_named("eager_int8")), device="cpu")
    np.testing.assert_array_equal(chunked.generate(PROMPTS, 6), want)


def test_int8_kv_cache_layout():
    from repro_torch.models import model as tmodel
    from repro_torch.serve.engine import state_batch_axes

    _, tcfg, _, _ = _llama()
    cfg = replace(tcfg, kv_quant="int8")
    state = tmodel.init_state(cfg, 3, 16, device="cpu")
    from repro_torch.tree import flatten

    flat = flatten(state)
    assert any(k.endswith("k_scale") for k in flat)
    for k, v in flat.items():
        assert v.dtype == (F32 if k.endswith("scale") else torch.int8), k
    axes = state_batch_axes(cfg, 16)
    assert len(axes) == len(flat)
    for (k, v), ax in zip(flat.items(), axes):
        assert v.shape[ax] == 3, k
