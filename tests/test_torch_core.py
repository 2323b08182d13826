"""The port's core modules against their JAX counterparts on the same
NumPy inputs: the LUT table, activations, norms, attention, the unified
linear's gather/accumulate modes, routing and the MoE layer (scalar task,
per-sequence task vector, padded groups, capacity drops, stats).

float32 throughout; tolerance ``rtol = atol = 1e-5`` unless stated (float32
sums in another order), integer outputs exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs import m3vit as JM
from repro.core import attention as JA
from repro.core import gelu as JG
from repro.core import moe as JMOE
from repro.core import routing as JR
from repro.core import unified_linear as JUL
from repro.models import layers as JL
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.configs import m3vit as TM
from repro_torch.core import attention as TA
from repro_torch.core import gelu as TG
from repro_torch.core import moe as TMOE
from repro_torch.core import routing as TR
from repro_torch.core import unified_linear as TUL
from repro_torch.models import layers as TL


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["gelu", "silu"])
@pytest.mark.parametrize("step_log2,rng_", [(-8, 8.0), (-6, 4.0)])
def test_lut_table_bit_identical(kind, step_log2, rng_):
    np.testing.assert_array_equal(
        TG._cached_table(kind, step_log2, rng_),
        JG._cached_table(kind, step_log2, rng_))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_activations(rng, dtype):
    x = rng.normal(scale=3, size=(257,)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    gj, gt = JG.exact_gelu(xj), TG.exact_gelu(xt)
    assert str(gt.dtype).endswith(str(gj.dtype))      # bf16 promotes to f32
    close(gt.float(), np.asarray(gj, np.float32), 1e-6)
    close(TG.exact_silu(xt.float()), JG.exact_silu(xj.astype(jnp.float32)),
          1e-6)


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_apply_norm(rng, norm):
    from dataclasses import replace

    jcfg = replace(JM.SMOKE_CONFIG, norm=norm)
    tcfg = replace(TM.SMOKE_CONFIG, norm=norm)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = {"scale": rng.normal(size=(64,)).astype(np.float32),
         "bias": rng.normal(size=(64,)).astype(np.float32)}
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), jcfg)
    got = TL.apply_norm({k: t(v) for k, v in p.items()}, t(x), tcfg)
    close(got, want)


# (B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset)
ATTN = [(1, 4, 2, 33, 77, 16, True, 9, 40), (2, 3, 3, 20, 20, 8, False, None, 0),
        (1, 2, 1, 70, 70, 8, False, 5, 0), (2, 4, 4, 16, 16, 8, True, None, 0)]


@pytest.mark.parametrize("impl", ["naive", "blocked"])
@pytest.mark.parametrize("case", ATTN, ids=str)
def test_attention_impls(rng, impl, case):
    b, hq, hkv, sq, skv, d, causal, window, q_offset = case
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if impl == "naive":
        want = JA.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
        got = TA.naive_attention(t(q), t(k), t(v), **kw)
    else:
        want = JA.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), block_k=32, **kw)
        got = TA.blocked_attention(t(q), t(k), t(v), block_k=32, **kw)
    close(got, want)


@pytest.mark.parametrize("mode", ["gather", "accumulate", "gather_accumulate",
                                  "preferred_dtype"])
def test_unified_linear_modes(rng, mode):
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(12, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    idx = np.array([3, 0, 3, 8], np.int32)
    kw_j, kw_t = {}, {}
    if "gather" in mode:
        kw_j["token_index"], kw_t["token_index"] = jnp.asarray(idx), t(idx)
    if "accumulate" in mode:
        acc = rng.normal(size=(2, 9, 7)).astype(np.float32)
        wt = rng.normal(size=(2, 4 if "gather" in mode else 9)) \
            .astype(np.float32)
        kw_j.update(accum_out=jnp.asarray(acc), accum_weight=jnp.asarray(wt))
        kw_t.update(accum_out=t(acc), accum_weight=t(wt))
    if mode == "preferred_dtype":
        kw_j["preferred_dtype"], kw_t["preferred_dtype"] = \
            jnp.float32, torch.float32
    for jpol, tpol in (("xla", "eager"), ("pallas", "cuda"), ("ref", "ref")):
        with jops.use_policy(jops.policy_named(jpol)):
            want = JUL.unified_linear(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), activation="relu",
                                      **kw_j)
        with ops.use_policy(ops.policy_named(tpol)):
            got = TUL.unified_linear(t(x), t(w), t(b), activation="relu",
                                     **kw_t)
        close(got, want)


def test_route_topk_breaks_ties_toward_lower_index():
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, -1.0, 0.0, -1.0, 0.0]], np.float32)
    ej, gj, pj = JR.route_topk(jnp.asarray(logits), 3)
    et, gt, pt = TR.route_topk(t(logits), 3)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    close(gt, gj)
    close(pt, pj)


@pytest.mark.parametrize("capacity", [3, 40])
def test_routing_pipeline(rng, capacity):
    """route → counts → dispatch → combine → aux, capacity drops included;
    the port's leading group axis against a per-group loop."""
    g, tok, e, k, d = 3, 20, 6, 2, 5
    logits = rng.normal(size=(g, tok, e)).astype(np.float32)
    x = rng.normal(size=(g, tok, d)).astype(np.float32)
    out = rng.normal(size=(g, e, capacity, d)).astype(np.float32)
    mask = rng.random((g, tok)) > 0.2
    rt = TR.route(t(logits), k, capacity)
    counts_t = TR.dispatch_counts(rt, e)
    buf_t = TR.dispatch(t(x), rt, e, capacity)
    y_t = TR.combine(t(out), rt)
    aux_t = TR.load_balance_loss(rt.probs, rt.expert, e, mask=t(mask))
    for i in range(g):
        rj = JR.route(jnp.asarray(logits[i]), k, capacity)
        for name in ("expert", "position", "valid"):
            np.testing.assert_array_equal(getattr(rt, name)[i].numpy(),
                                          np.asarray(getattr(rj, name)))
        close(rt.gate[i], rj.gate)
        np.testing.assert_array_equal(counts_t[i].numpy(),
                                      np.asarray(JR.dispatch_counts(rj, e)))
        np.testing.assert_array_equal(
            buf_t[i].numpy(),
            np.asarray(JR.dispatch(jnp.asarray(x[i]), rj, e, capacity)))
        close(y_t[i], JR.combine(jnp.asarray(out[i]), rj))
        close(aux_t[i], JR.load_balance_loss(rj.probs, rj.expert, e,
                                             mask=jnp.asarray(mask[i])))


MOE_CASES = {
    # (expert kind, tokens (B, S), group size, capacity factor, task,
    #  shared experts, per-task gate bias)
    "gelu_scalar_task": ("gelu", (2, 16), 16, 2.0, 1, 0, False),
    "gelu_padded_groups_drops": ("gelu", (3, 7), 8, 0.5, 0, 0, False),
    "gelu_task_vector": ("gelu", (4, 6), 8, 1.0, [1, 0, 0, 1], 0, False),
    "gelu_gate_bias": ("gelu", (2, 8), 8, 1.0, 1, 0, True),
    "gelu_task_vector_gate_bias": ("gelu", (2, 8), 8, 1.0, [1, 0], 0, True),
    "swiglu_task_vector_padded": ("swiglu", (3, 5), 4, 1.0, [0, 1, 1], 0,
                                  False),
    "swiglu_shared_expert": ("swiglu", (2, 6), 8, 2.0, 0, 1, False),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("policies", [("xla", "eager"), ("pallas", "cuda"),
                                      ("ref", "ref")],
                         ids=lambda p: p[1])
def test_apply_moe(rng, case, policies):
    kind, (b, s), group, cf, task, shared, gate_bias = MOE_CASES[case]
    common = dict(d_model=16, d_ff=24, num_experts=6, top_k=2, num_tasks=2,
                  expert_kind=kind, capacity_factor=cf, group_size=group,
                  num_shared_experts=shared)
    jcfg = JMOE.MoEConfig(**common)
    tcfg = TMOE.MoEConfig(**common)
    jp = dict(JMOE.init_moe(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32))
    if gate_bias:
        jp["gate_bias"] = jnp.asarray(rng.normal(size=(2, 6)), jnp.float32)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    x = rng.normal(size=(b, s, 16)).astype(np.float32)
    jtask = task if isinstance(task, int) else jnp.asarray(task, jnp.int32)
    ttask = task if isinstance(task, int) else torch.tensor(task)
    jpol, tpol = policies
    with jops.use_policy(jops.policy_named(jpol)):
        yj, auxj, cj = JMOE.apply_moe(jp, jcfg, jnp.asarray(x), task_id=jtask,
                                      return_stats=True)
    with ops.use_policy(ops.policy_named(tpol)):
        yt, auxt, ct = TMOE.apply_moe(tp, tcfg, t(x), task_id=ttask,
                                      return_stats=True)
    close(yt, yj)
    close(auxt, auxj)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert ct.dtype == torch.int32


def test_apply_moe_refuses_unported_impls():
    cfg = TMOE.MoEConfig(d_model=8, d_ff=8, num_experts=2, top_k=1,
                         impl="onehot")
    with pytest.raises(NotImplementedError, match="onehot"):
        TMOE.apply_moe({}, cfg, torch.zeros((1, 2, 8)))
