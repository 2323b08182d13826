"""The port's two fused kernels against the JAX Pallas kernels, and M³ViT
under the fused policies against the JAX reference, on the CPU.

* ``moe_fused``: the plain version (what the wrapper runs for CPU tensors)
  against ``repro.kernels.ops.fused_moe_ffn(..., interpret=True)`` on the
  same routing, one routing group at a time on the JAX side.  GELU and
  SwiGLU experts, exact and LUT activations, top-k 1, 2 and 4, empty
  queues, capacity drops and several groups.
* ``decode_fused``: the plain version against
  ``repro.kernels.ops.fused_decode_attention(..., interpret=True)``:
  non-uniform ``cache_len`` with 0 and Smax, with and without a window,
  GQA groups 1 and 4, head_dim 64 and 128, float32 and bf16.
* M³ViT on ``SMOKE_CONFIG``: the port's ``forward`` under ``cuda_fused``
  against JAX under ``pallas_fused``, and under ``cuda`` +
  ``moe_ffn="cuda_fused"`` against ``pallas`` + ``moe_ffn="pallas_fused"``.

Tolerances (``repro_torch.kernels.compare``): float32 ``1e-5 +
1e-5·|ref|``; bf16 one ulp more.  Under the LUT a hidden unit whose float32
pre-activation lies on a table-index half-step may take the neighbouring
entry; ``moe_lut_allowance`` carries that one table step through the down
projection to the output.  ``cache_len == 0`` gives exact zeros.  The
M³ViT bounds are those of ``test_torch_m3vit.py``: float32 1e-4 of the
output's magnitude with exact activations, the fixed 5e-4 with the LUT;
bf16 cosine >= 0.999.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs import m3vit as JM
from repro.kernels import ops as jk
from repro.models import vit as jvit
from repro_torch import ops
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import m3vit as TM
from repro_torch.core import routing as R
from repro_torch.core.moe import MoEConfig
from repro_torch.kernels import decode_fused as kdf
from repro_torch.kernels import launch_counts
from repro_torch.kernels import moe_fused as kmf
from repro_torch.kernels.compare import (cosine, kernel_tolerance,
                                         moe_lut_allowance, within_tolerance)
from repro_torch.kernels.ref import ref_moe_ffn
from repro_torch.models import vit
from test_torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LUT_BOUND = 5e-4     # test_torch_m3vit.py:LUT_BOUND, from its readings


def pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    j = jnp.asarray(a, DTYPES[dtype][0])
    return j, tensor_from_numpy(np.asarray(jax.device_get(j)))


def to_torch(j) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(jax.device_get(j)))


def assert_close(got, want, dtype, **kw):
    tol = kernel_tolerance(got, want, dtype, **kw)
    err = (got.float() - want.float()).abs()
    assert within_tolerance(got, want, dtype, **kw), (
        f"{int((err > tol).sum())} of {err.numel()} elements out of "
        f"tolerance; max err {float(err.max())}")


# ------------------------------------------------------------ moe_fused


def _expert_params(rng, kind, e, d, f, dtype):
    if kind == "swiglu":
        names = {"wg": (e, d, f, d), "wu": (e, d, f, d), "wd": (e, f, d, f)}
        return {n: pair(rng.normal(size=s[:3]) / np.sqrt(s[3]), dtype)
                for n, s in names.items()}
    return {"w1": pair(rng.normal(size=(e, d, f)) / np.sqrt(d), dtype),
            "b1": pair(rng.normal(size=(e, f)) * 0.1, "float32"),
            "w2": pair(rng.normal(size=(e, f, d)) / np.sqrt(f), dtype),
            "b2": pair(rng.normal(size=(e, d)) * 0.1, "float32")}


def _moe_case(rng, *, kind, dtype, g, t, d, f, e, k, capacity, dead=()):
    """Inputs of both sides: x, expert params and one routing of (G, T)
    tokens; experts in ``dead`` get no token (their gate logit is far
    below the others)."""
    xj, xt = pair(rng.normal(size=(g, t, d)), dtype)
    params = _expert_params(rng, kind, e, d, f, dtype)
    logits = rng.normal(size=(g, t, e)).astype(np.float32)
    logits[..., list(dead)] = -30.0
    r = R.route(torch.from_numpy(logits), k, capacity)
    sizes = R.dispatch_counts(r, e)
    return xj, xt, params, r, sizes


def _jax_fused(xj, params, r, sizes, **kw):
    """The Pallas kernel in interpret mode, one routing group at a time."""
    jp = {n: v[0] for n, v in params.items()}
    outs = []
    for i in range(xj.shape[0]):
        fields = [jnp.asarray(a[i].numpy()) for a in
                  (r.expert, r.gate, r.position, r.valid, sizes)]
        outs.append(jk.fused_moe_ffn(xj[i], jp, *fields, interpret=True,
                                     **kw))
    return to_torch(jnp.stack(outs))


MOE_SHAPES = {  # (G, T, d, f, E, k, C, dead experts)
    "top1_two_groups": (2, 40, 24, 40, 6, 1, 12, ()),
    "top2_capacity_drops": (2, 37, 24, 40, 6, 2, 8, ()),
    "top4_empty_experts": (3, 29, 32, 48, 8, 4, 20, (1, 6)),
}


@pytest.mark.parametrize("shape", list(MOE_SHAPES))
@pytest.mark.parametrize("lut", [False, True], ids=["exact", "lut"])
@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_fused_plain_matches_pallas(rng, shape, lut, kind, dtype):
    g, t, d, f, e, k, c, dead = MOE_SHAPES[shape]
    xj, xt, params, r, sizes = _moe_case(rng, kind=kind, dtype=dtype, g=g,
                                         t=t, d=d, f=f, e=e, k=k,
                                         capacity=c, dead=dead)
    if dead:
        assert (sizes[:, list(dead)] == 0).all()
    if shape == "top2_capacity_drops":
        assert not bool(r.valid.all())
    kw = dict(kind=kind, capacity=c, use_lut=lut)
    want = _jax_fused(xj, params, r, sizes, **kw)
    tp = {n: v[1] for n, v in params.items()}
    got = kmf.fused_moe_ffn(xt, tp, r.expert, r.gate, r.position, r.valid,
                            sizes, **kw)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    extra = moe_lut_allowance(xt, tp, r.expert, r.gate, r.valid,
                              kind=kind) if lut else None
    assert_close(got, want, DTYPES[dtype][1], extra=extra)


@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
def test_moe_fused_matches_the_dense_oracle(rng, kind):
    """Exact activations at float32 against ``ref_moe_ffn`` (every expert
    on every token, combined with the valid gates)."""
    g, t, d, f, e, k, c = 2, 33, 16, 24, 5, 2, 40     # no capacity drops
    _, xt, params, r, sizes = _moe_case(rng, kind=kind, dtype="float32",
                                        g=g, t=t, d=d, f=f, e=e, k=k,
                                        capacity=c)
    assert bool(r.valid.all())
    tp = {n: v[1] for n, v in params.items()}
    got = kmf.fused_moe_ffn(xt, tp, r.expert, r.gate, r.position, r.valid,
                            sizes, kind=kind, capacity=c, use_lut=False)
    cfg = MoEConfig(d_model=d, d_ff=f, num_experts=e, top_k=k,
                    expert_kind=kind)
    torch.testing.assert_close(got, ref_moe_ffn(xt, tp, r, cfg=cfg),
                               rtol=1e-5, atol=1e-5)


def test_moe_fused_dead_slots_contribute_nothing(rng):
    """A token whose every slot was dropped by capacity gets exact zeros,
    though its expert's bias alone would give act(b1) @ w2 + b2 != 0."""
    g, t, d, f, e, k, c = 1, 30, 8, 16, 3, 1, 4
    _, xt, params, r, sizes = _moe_case(rng, kind="gelu", dtype="float32",
                                        g=g, t=t, d=d, f=f, e=e, k=k,
                                        capacity=c)
    tp = {n: v[1] for n, v in params.items()}
    got = kmf.fused_moe_ffn(xt, tp, r.expert, r.gate, r.position, r.valid,
                            sizes, kind="gelu", capacity=c)
    dropped = ~r.valid.any(dim=-1)
    assert bool(dropped.any())
    assert (got[dropped] == 0).all()
    assert (got[~dropped] != 0).any(dim=-1).all()


def test_build_queues_matches_the_reference_construction(rng):
    """tok_idx / gates as ``kernels/ops.py:fused_moe_ffn`` builds them
    (the scrap column at index C), per group, and the routing slot of each
    live entry."""
    g, t, e, k, c = 2, 21, 5, 2, 6
    logits = torch.from_numpy(rng.normal(size=(g, t, e)).astype(np.float32))
    r = R.route(logits, k, c)
    tok_idx, gates, slot_idx = kmf.build_queues(r.expert, r.gate,
                                                r.position, r.valid, e, c)
    for i in range(g):
        eidx = jnp.asarray(r.expert[i].numpy()).reshape(-1)
        p = jnp.asarray(r.position[i].numpy()).reshape(-1)
        v = jnp.asarray(r.valid[i].numpy()).reshape(-1)
        gv = jnp.asarray(r.gate[i].numpy()).reshape(-1) * v
        tokids = jnp.repeat(jnp.arange(t, dtype=jnp.int32), k)
        p_safe = jnp.where(v, p, c)
        want_tok = jnp.full((e, c + 1), -1, jnp.int32).at[
            eidx, p_safe].set(tokids)[:, :c]
        want_gate = jnp.zeros((e, c + 1), jnp.float32).at[
            eidx, p_safe].set(gv)[:, :c]
        np.testing.assert_array_equal(tok_idx[i].numpy(), want_tok)
        np.testing.assert_array_equal(gates[i].numpy(), want_gate)
    live = tok_idx >= 0
    assert ((slot_idx >= 0) == live).all()
    gi, ei, ci = torch.nonzero(live, as_tuple=True)
    ti, si = tok_idx[gi, ei, ci].long(), slot_idx[gi, ei, ci].long()
    assert (r.expert[gi, ti, si] == ei).all()
    assert (r.position[gi, ti, si] == ci).all()


@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
def test_apply_moe_pads_groups_through_the_fused_kernel(kind):
    """``apply_moe`` with 2 × 21 tokens in groups of 16 (6 pad rows in the
    last group, routed and holding capacity like real ones) under
    ``cuda_fused`` against the JAX ``apply_moe`` under ``pallas_fused``,
    per-sequence tasks, exact activations, float32."""
    from repro.core import moe as jmoe
    from repro_torch.core import moe as tmoe

    kw = dict(d_model=24, d_ff=40, num_experts=6, top_k=2, num_tasks=2,
              expert_kind=kind, capacity_factor=1.0, group_size=16)
    jcfg, tcfg = jmoe.MoEConfig(**kw), MoEConfig(**kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    tp = {n: to_torch(v) for n, v in jp.items()}
    x = np.random.default_rng(4).normal(size=(2, 21, 24)).astype(np.float32)
    tasks = np.array([1, 0], np.int32)
    with jops.use_policy(POLICIES["fused_exact"][0]):
        want, want_aux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x),
                                        task_id=jnp.asarray(tasks))
    ops.reset_dispatch_report()
    with ops.use_policy(POLICIES["fused_exact"][1]):
        got, aux = tmoe.apply_moe(tp, tcfg, torch.from_numpy(x),
                                  task_id=torch.from_numpy(tasks))
    assert ops.dispatch_report()["moe_ffn"]["hits"] == {"cuda_fused": 1}
    torch.testing.assert_close(got, to_torch(want), rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))


# ------------------------------------------------------------ decode_fused

# (B, Hq, Hkv, Smax, D, cache_len)
DECODE_CASES = {
    "gqa4_d64": (4, 8, 2, 40, 64, [0, 40, 17, 1]),
    "gqa1_d128": (3, 4, 4, 37, 128, [37, 0, 9]),
    "gqa4_d128_long": (2, 4, 1, 150, 128, [150, 64]),
    "gqa1_d64_ragged": (5, 3, 3, 70, 64, [0, 1, 33, 69, 70]),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
@pytest.mark.parametrize("window", [None, 5], ids=["full", "window5"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_fused_plain_matches_pallas(rng, case, window, dtype):
    b, hq, hkv, smax, d, lengths = DECODE_CASES[case]
    qj, qt = pair(rng.normal(size=(b, hq, 1, d)), dtype)
    kj, kt = pair(rng.normal(size=(b, hkv, smax, d)), dtype)
    vj, vt = pair(rng.normal(size=(b, hkv, smax, d)), dtype)
    want = to_torch(jk.fused_decode_attention(
        qj, kj, vj, jnp.asarray(lengths, jnp.int32), window=window,
        interpret=True))
    got = kdf.fused_decode_attention(qt, kt, vt,
                                     torch.tensor(lengths, dtype=torch.int32),
                                     window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert_close(got, want, DTYPES[dtype][1])
    for i, n in enumerate(lengths):
        if n == 0:      # exact zeros: +0.0
            assert (got[i].float().numpy().view(np.uint32) == 0).all()


def test_decode_fused_scalar_length_broadcasts(rng):
    q = torch.from_numpy(rng.normal(size=(3, 4, 1, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(3, 2, 12, 16)).astype(np.float32))
    got = kdf.fused_decode_attention(q, k, k, 7)
    want = kdf.fused_decode_attention(q, k, k, torch.tensor([7, 7, 7]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------------ wrappers


def test_fused_wrappers_run_plain_versions_on_the_cpu(rng):
    before = launch_counts()
    _, xt, params, r, sizes = _moe_case(rng, kind="gelu", dtype="float32",
                                        g=1, t=8, d=8, f=8, e=2, k=1,
                                        capacity=8)
    kmf.fused_moe_ffn(xt, {n: v[1] for n, v in params.items()}, r.expert,
                      r.gate, r.position, r.valid, sizes, kind="gelu",
                      capacity=8)
    q = torch.zeros((1, 2, 1, 8))
    kdf.fused_decode_attention(q, q, q, 1)
    assert launch_counts() == before


@pytest.mark.parametrize("name", ["moe_fused", "decode_fused"])
def test_fused_wrappers_refuse_other_devices(name, monkeypatch):
    """As ``test_torch_kernels.py``'s: meta stands in for another device,
    with the plain devices narrowed to the CPU."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "PLAIN_DEVICES", ("cpu",))
    x = torch.empty((1, 4, 8), device="meta")
    calls = {
        "moe_fused": lambda: kmf.fused_moe_ffn(
            x, {}, x, x, x, x, x, kind="gelu", capacity=4),
        "decode_fused": lambda: kdf.fused_decode_attention(
            x[None], x[None], x[None], 1),
    }
    with pytest.raises(ValueError, match="runs on cuda, cpu or meta"):
        calls[name]()


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
def test_fused_moe_impl_never_gives_way_on_the_card(monkeypatch, on_card):
    """A ``cuda_fused`` rejection (here: d_model past the kernel's limit)
    moves down the chain on the CPU and raises with operands on the card."""
    from repro_torch.ops import registry

    d = kmf.MAX_D + 8
    cfg = MoEConfig(d_model=d, d_ff=8, num_experts=2, top_k=1,
                    expert_kind="gelu")
    x = torch.zeros((1, 4, d))
    params = {"w1": torch.zeros((2, d, 8)), "b1": torch.zeros((2, 8)),
              "w2": torch.zeros((2, 8, d)), "b2": torch.zeros((2, d))}
    r = R.route(torch.zeros((1, 4, 2)), 1, 4)
    sizes = R.dispatch_counts(r, 2)
    ops.reset_dispatch_report()
    with ops.use_policy(ops.policy_named("cuda_fused")):
        if on_card:
            monkeypatch.setattr(registry, "_mode", lambda a: "cuda")
            with pytest.raises(ops.DispatchError, match="d_model"):
                ops.dispatch("moe_ffn", x, params, r, sizes, cfg=cfg,
                             capacity=4)
        else:
            ops.dispatch("moe_ffn", x, params, r, sizes, cfg=cfg, capacity=4)
            (fb,) = ops.dispatch_report()["moe_ffn"]["fallbacks"]
            assert fb["used"] == "eager"
            assert f"d_model {d} > {kmf.MAX_D}" in fb["reasons"][0]


def test_cuda_fused_preset():
    p = ops.policy_named("cuda_fused")
    assert dict(p.impls) == {"activation": "lut", "attention": "blocked",
                             "moe_ffn": "cuda_fused",
                             "attention_decode": "cuda_fused"}
    assert p.lut_activations
    with pytest.raises(ValueError, match="cuda_fused"):
        ops.policy_named("pallas_fused")


# ------------------------------------------------------------ M³ViT

POLICIES = {  # name: (JAX policy, port policy)
    "fused": (jops.policy_named("pallas_fused"),
              ops.policy_named("cuda_fused")),
    "kernels_fused_moe": (
        jops.policy_named("pallas").with_impls(moe_ffn="pallas_fused"),
        ops.policy_named("cuda").with_impls(moe_ffn="cuda_fused")),
    "fused_exact": (
        jops.policy_named("pallas_fused").with_impls(activation="xla"),
        ops.policy_named("cuda_fused").with_impls(activation="eager")),
}


@functools.lru_cache(maxsize=None)
def _m3vit(dtype):
    jcfg = replace(JM.SMOKE_CONFIG, dtype=dtype)
    tcfg = replace(TM.SMOKE_CONFIG, dtype=dtype)
    jparams = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    img = np.random.default_rng(1).normal(
        size=(2, TM.IMAGE_H, TM.IMAGE_W, 3)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, img


@functools.lru_cache(maxsize=None)
def _jax_m3vit(policy_name, dtype, task):
    jcfg, _, jparams, _, img = _m3vit(dtype)
    with jops.use_policy(POLICIES[policy_name][0]):
        y, _ = jvit.forward(jparams, jnp.asarray(img), jcfg, task=task)
    return np.array(y)


@pytest.mark.parametrize("task", TM.TASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["fused", "kernels_fused_moe"])
def test_m3vit_under_fused_policies_matches_jax(policy, dtype, task):
    _, tcfg, _, tparams, img = _m3vit(dtype)
    want = _jax_m3vit(policy, dtype, task)
    ops.reset_dispatch_report()
    with ops.use_policy(POLICIES[policy][1]):
        got, _ = vit.forward(tparams, torch.from_numpy(img), tcfg, task=task)
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    n_moe = tcfg.num_layers // 2
    entry = ops.dispatch_report()["moe_ffn"]
    assert entry["hits"] == {"cuda_fused": n_moe}
    assert entry["fallbacks"] == []
    assert entry["modes"] == {"cuda_fused": {"cpu": n_moe}}
    if dtype == "bfloat16":
        assert cosine(torch.from_numpy(got), torch.from_numpy(want)) >= 0.999
    else:
        assert np.abs(got - want).max() <= LUT_BOUND * np.abs(want).max()


@pytest.mark.parametrize("task", TM.TASKS)
def test_m3vit_fused_exact_activations_fp32(task):
    _, tcfg, _, tparams, img = _m3vit("float32")
    want = _jax_m3vit("fused_exact", "float32", task)
    with ops.use_policy(POLICIES["fused_exact"][1]):
        got, _ = vit.forward(tparams, torch.from_numpy(img), tcfg, task=task)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
