"""Serving packed expert weights in the port — paged QTensor and
FactoredTensor experts, the factored and quantized ``M3ViTServer`` — on
the CPU, against the port's own all-resident path and the JAX reference.

* ``PagedMoE`` over int8 / int4 experts (``eager_int8``) and factored
  experts (rank and butterfly, float32 / int8 / int4 deltas, the
  parameters of ``tests/test_factor_serve.py``; ``eager_factored``), GELU
  and SwiGLU, both tasks, at resident fractions 0.25 and 1.0: bit-exact
  with the all-resident ``apply_moe``, and within ``rtol = atol = 1e-5``
  of the reference's ``PagedMoE`` on the same parameters.  The same under
  the launcher's policy (``cuda`` with the packed ops overridden: the
  kernels' plain versions here).
* The basis is pinned, not paged: ``pinned_bytes`` > 0, the paged unit is
  the delta, and bytes paged are whole deltas.  The slots a byte budget
  buys, the per-expert bytes and the pinned bytes equal the reference's
  for the same budget.
* ``M3ViTServer(factor=...)`` and a quantized ``M3ViTServer`` against the
  reference's servers (float32 ``SMOKE_CONFIG``, exact activations:
  within 1e-4 × the output's max magnitude, the bound of
  ``tests/test_torch_m3vit.py``), and paged equal to all-resident bit for
  bit.
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
from repro.core import moe as JMOE
from repro.factor import factorize_tree as jfactorize_tree
from repro.models import vit as jvit
from repro.quant import quantize_tree as jquantize_tree
from repro.serve import expert_cache as JEC
from repro.serve import vision as JV
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.configs import m3vit as TM
from repro_torch.core import moe as TMOE
from repro_torch.factor import is_factored
from repro_torch.serve import expert_cache as TEC
from repro_torch.serve.vision import M3ViTServer
from test_torch_threads import one_torch_thread  # noqa: F401

FORMATS = {  # name: (JAX converter, JAX policy, port policy)
    "int8": (lambda p: jquantize_tree(p, bits=8), "xla_int8", "eager_int8"),
    "int4": (lambda p: jquantize_tree(p, bits=4), "xla_int8", "eager_int8"),
}
for _kind, _bits in (("rank", None), ("rank", 8), ("rank", 4),
                     ("butterfly", None), ("butterfly", 8)):
    FORMATS[f"{_kind}-{_bits}"] = (
        functools.partial(jfactorize_tree, kind=_kind, rank=4,
                          delta_bits=_bits), "xla_factored",
        "eager_factored")
#: the launcher's policy for each family: the kernels plus the packed ops
LAUNCH = {"eager_int8": ops.policy_named("cuda").with_impls(
    linear="eager_int8", moe_grouped_gemm="eager_int8",
    attention_decode="eager_int8"),
    "eager_factored": ops.policy_named("cuda").with_impls(
        moe_grouped_gemm="eager_factored")}


def _cfgs(expert_kind):
    kw = dict(d_model=32, d_ff=64, num_experts=8, top_k=2, num_tasks=2,
              capacity_factor=2.0, group_size=64, expert_kind=expert_kind)
    return JMOE.MoEConfig(impl="grouped", **kw), TMOE.MoEConfig(**kw)


@functools.lru_cache(maxsize=None)
def _setup(fmt, expert_kind):
    jcfg, tcfg = _cfgs(expert_kind)
    jp = dict(JMOE.init_moe(jax.random.PRNGKey(0), jcfg,
                            dtype=jnp.float32))
    jpacked = FORMATS[fmt][0](jp)
    tpacked = params_from_jax(jax.device_get(jpacked), device="cpu")
    x = (jax.random.normal(jax.random.PRNGKey(1), (2, 50, 32))
         * 0.5).astype(jnp.float32)
    tx = torch.from_numpy(np.array(x))
    return jcfg, tcfg, jpacked, tpacked, x, tx


@pytest.mark.parametrize("expert_kind", ["gelu", "swiglu"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_paged_bitexact_with_direct(fmt, expert_kind):
    jcfg, tcfg, jp, tp, x, tx = _setup(fmt, expert_kind)
    _, jpol, tpol = FORMATS[fmt]
    for name, policy in ((tpol, ops.policy_named(tpol)),
                         ("launcher", LAUNCH[tpol])):
        with ops.use_policy(policy):
            for task in (0, 1):
                ref, aux_ref = TMOE.apply_moe(tp, tcfg, tx, task_id=task)
                for frac in (0.25, 1.0):
                    paged = TEC.PagedMoE(tp, tcfg, resident_fraction=frac,
                                         device="cpu")
                    y, aux = paged(tx, task_id=task)
                    assert torch.equal(y, ref), (name, task, frac)
                    assert float(aux) == pytest.approx(float(aux_ref),
                                                       rel=1e-6)
                    if frac < 1.0:
                        assert paged.cache.misses > 0   # it really paged
    with jops.use_policy(jops.policy_named(jpol)):
        want = JEC.PagedMoE(jp, jcfg, resident_fraction=0.25)(x, task_id=1)
    with ops.use_policy(ops.policy_named(tpol)):
        got = TEC.PagedMoE(tp, tcfg, resident_fraction=0.25,
                           device="cpu")(tx, task_id=1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)


def _float_params():
    return params_from_jax(jax.device_get(dict(JMOE.init_moe(
        jax.random.PRNGKey(0), _cfgs("gelu")[0], dtype=jnp.float32))),
        device="cpu")


def test_basis_is_pinned_not_paged():
    _, tcfg, _, tp, _, tx = _setup("rank-None", "gelu")
    paged = TEC.PagedMoE(tp, tcfg, resident_fraction=0.25, device="cpu")
    s = paged.cache.stats()
    assert s["pinned_bytes"] == 2 * 32 * 64 * 4        # w1, w2 bases f32
    assert set(paged.cache.pinned) == {"w1.basis", "w2.basis"}
    assert not any("basis" in n for n in paged.cache.names)
    dense = TEC.PagedMoE(_float_params(), tcfg, resident_fraction=0.25,
                         device="cpu").cache.stats()
    assert dense["pinned_bytes"] == 0
    assert s["paged_expert_bytes"] < dense["paged_expert_bytes"] / 3
    with ops.use_policy(ops.policy_named("eager_factored")):
        paged(tx, task_id=0)
    st = paged.cache.stats()
    assert st["bytes_paged"] > 0
    assert st["bytes_paged"] % s["paged_expert_bytes"] == 0


@pytest.mark.parametrize("fmt", ["int8", "int4", "rank-None", "rank-8",
                                 "butterfly-8"])
def test_budget_sizing_equals_reference(fmt):
    jcfg, tcfg, jp, tp, _, _ = _setup(fmt, "gelu")
    jprobe = JEC.PagedMoE(jp, jcfg, resident_fraction=1.0)
    tprobe = TEC.PagedMoE(tp, tcfg, resident_fraction=1.0, device="cpu")
    js, ts = jprobe.cache.stats(), tprobe.cache.stats()
    assert ts["paged_expert_bytes"] == js["paged_expert_bytes"]
    assert ts["pinned_bytes"] == js["pinned_bytes"]
    per, pinned = ts["paged_expert_bytes"], ts["pinned_bytes"]
    for budget in (0, pinned - 1, pinned + 3 * per, pinned + 5 * per + 7,
                   4 * 8 * (32 * 64 * 2 + 64 + 32) * 4):
        budget = max(0, budget)
        want = JEC.PagedMoE(jp, jcfg, budget_bytes=budget).cache.max_resident
        got = TEC.PagedMoE(tp, tcfg, budget_bytes=budget,
                           device="cpu").cache.max_resident
        assert got == want, (fmt, budget)


def test_packed_budget_holds_more_experts():
    """Two float32 experts' bytes (16768 B each here): int8 experts (4864
    B) fill 6 slots, int4 (2944 B) and rank-4 int8 deltas (1568 B, the
    pinned basis paid first) all 8."""
    _, tcfg = _cfgs("gelu")
    dense = TEC.PagedMoE(_float_params(), tcfg, resident_fraction=1.0,
                         device="cpu")
    budget = 2 * dense.cache.stats()["paged_expert_bytes"]

    def slots(params):
        pinned = TEC.PagedMoE(params, tcfg, device="cpu").cache.pinned_bytes
        return TEC.PagedMoE(params, tcfg, budget_bytes=budget + pinned,
                            device="cpu").cache.max_resident
    assert slots(_float_params()) == 2
    assert [slots(_setup(f, "gelu")[3]) for f in ("int8", "int4",
                                                  "rank-8")] == [6, 8, 8]


# ================================================================ servers


def _images(b=1, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, TM.IMAGE_H, TM.IMAGE_W, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _server_params():
    jcfg = replace(JM.SMOKE_CONFIG, dtype="float32")
    jparams = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    return jparams, params_from_jax(jax.device_get(jparams), device="cpu")


SERVERS = {  # name: (quant bits, factor, JAX policy, port policy)
    "rank-8": (None, ("rank", 8, None),
               jops.policy_named("xla").with_impls(
                   moe_grouped_gemm="xla_factored"),
               ops.policy_named("eager").with_impls(
                   moe_grouped_gemm="eager_factored")),
    "butterfly-int8": (8, ("butterfly", 0, 8),
                       jops.policy_named("xla").with_impls(
                           linear="xla_int8",
                           moe_grouped_gemm="xla_factored"),
                       ops.policy_named("eager").with_impls(
                           linear="eager_int8",
                           moe_grouped_gemm="eager_factored")),
    "int8": (8, None, jops.policy_named("xla").with_impls(
        linear="xla_int8", moe_grouped_gemm="xla_int8"),
        ops.policy_named("eager").with_impls(
            linear="eager_int8", moe_grouped_gemm="eager_int8")),
    "int4": (4, None, jops.policy_named("xla").with_impls(
        linear="xla_int8", moe_grouped_gemm="xla_int8"),
        ops.policy_named("eager").with_impls(
            linear="eager_int8", moe_grouped_gemm="eager_int8")),
}


@pytest.mark.parametrize("name", list(SERVERS))
def test_packed_server_matches_reference_and_pages_bit_exact(name):
    bits, factor, jpol, tpol = SERVERS[name]
    jparams, tparams = _server_params()
    if bits:
        jparams = jquantize_tree(jparams, bits=bits)
        tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    jcfg = replace(JM.SMOKE_CONFIG, dtype="float32", policy=jpol)
    tcfg = replace(TM.SMOKE_CONFIG, dtype="float32", policy=tpol)
    jserver = JV.M3ViTServer(jcfg, jparams, resident_fraction=0.5,
                             factor=factor)
    paged = M3ViTServer(tcfg, tparams, resident_fraction=0.5, factor=factor,
                        device="cpu")
    resident = M3ViTServer(tcfg, tparams, factor=factor, device="cpu")
    if factor:
        moe = [lp["moe"] for lp in resident.layer_params if "moe" in lp]
        assert moe and all(is_factored(m["w1"]) for m in moe)
        assert all(p.cache.pinned_bytes > 0 for p in paged.paged.values())
    img = _images()
    ops.reset_dispatch_report()
    for task in TM.TASKS:
        want = jserver.infer(img, task)
        got = paged.infer(img, task)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        np.testing.assert_array_equal(got, resident.infer(img, task))
    rep = ops.dispatch_report()
    impl = "eager_factored" if factor else "eager_int8"
    assert rep["moe_grouped_gemm"]["hits"].get(impl, 0) > 0
    assert not rep["moe_grouped_gemm"]["fallbacks"]
    if bits:
        assert rep["linear"]["hits"].get("eager_int8", 0) > 0
        assert not rep["linear"]["fallbacks"]
    assert paged.cache_stats()["bytes_paged"] > 0
