"""Factored experts in the port (``repro_torch.factor``, the
``eager_factored`` impls) against the JAX reference (``repro.factor``,
``xla_factored``), on the CPU.

* ``factorize`` gives the basis, ``u`` and ``v`` equal to the reference's
  bit for bit (the same host NumPy SVD seeding, the same quantizer), for
  ``rank`` and ``butterfly`` with ``delta_bits`` None, 8 and 4, stacked and
  single weights, float32 and bfloat16 inputs; ``split_dim`` agrees for
  every n up to 1024; ``factorize_tree`` factors the same leaves (the
  gate-sibling rule, nested or flat dotted names); the rejections match.
* ``eager_factored`` against ``xla_factored`` for ``linear`` and
  ``moe_grouped_gemm``: within ``kernels/compare.py``'s float32
  tolerance; ``reconstruct`` within float32 rounding.  Packed operands
  reach the factored impl as recorded fallbacks with the reference's
  reasons (the port's impl names).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.factor import factorize as jfactorize
from repro.factor import factorize_tree as jfactorize_tree
from repro.factor import reconstruct as jreconstruct
from repro.factor import split_dim as jsplit_dim
from repro_torch import ops
from repro_torch.bridge import params_from_jax
from repro_torch.factor import (FactoredTensor, factorize, factorize_tree,
                                is_factored, reconstruct, reconstruct_tree,
                                split_dim)
from repro_torch.kernels.compare import within_tolerance
from repro_torch.quant import is_qtensor, quantize_tree
from test_torch_threads import one_torch_thread  # noqa: F401

F32 = torch.float32


def _experts(seed, e, k, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(k, n))
    return (base[None] + 0.1 * rng.normal(size=(e, k, n))).astype(dtype)


def _same(j, t):
    """A reference factor (array or QTensor) equals the port's bit for
    bit."""
    if hasattr(j, "q"):
        assert is_qtensor(t) and t.bits == j.bits and t.rows == j.rows
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    else:
        assert isinstance(t, torch.Tensor) and t.dtype == F32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("delta_bits", [None, 8, 4])
@pytest.mark.parametrize("kind", ["rank", "butterfly"])
def test_factorize_bit_equal(kind, delta_bits, dtype):
    w = jnp.asarray(_experts(0, 5, 24, 36), dtype)
    tw = torch.from_numpy(np.array(w.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jf = jfactorize(w, kind, rank=4, delta_bits=delta_bits)
    tf = factorize(tw, kind, rank=4, delta_bits=delta_bits)
    assert isinstance(tf, FactoredTensor)
    assert (tf.kind, tf.dtype, tf.experts, tf.rank, tf.shape) == (
        jf.kind, jf.dtype, jf.experts, jf.rank, tuple(jf.shape))
    _same(jf.basis, tf.basis)
    _same(jf.u, tf.u)
    _same(jf.v, tf.v)
    assert (tf.basis_nbytes, tf.delta_nbytes) == (jf.basis_nbytes,
                                                  jf.delta_nbytes)
    got = reconstruct(tf, F32)
    want = torch.from_numpy(np.array(jreconstruct(jf, jnp.float32)))
    assert within_tolerance(got, want, F32)
    # the bridge rebuilds the reference's FactoredTensor, nested QTensors
    # included
    bridged = params_from_jax({"w1": jax.device_get(jf)}, device="cpu")["w1"]
    assert is_factored(bridged) and bridged.kind == kind
    _same(jf.u, bridged.u)
    _same(jf.basis, bridged.basis)


@pytest.mark.parametrize("rank", [0, 3, 100])
def test_single_weight_and_rank_edges(rank):
    w = _experts(1, 3, 16, 8)
    jf = jfactorize(jnp.asarray(w[0]), rank=rank,
                    basis=jnp.asarray(w.mean(0)), delta_bits=8)
    tf = factorize(torch.from_numpy(w[0]), rank=rank,
                   basis=torch.from_numpy(w.mean(0)), delta_bits=8)
    assert tf.experts is None and tf.rank == jf.rank
    for a, b in ((jf.basis, tf.basis), (jf.u, tf.u), (jf.v, tf.v)):
        _same(a, b)


def test_split_dim_matches():
    for n in range(1, 1025):
        assert split_dim(n) == jsplit_dim(n), n
    with pytest.raises(ValueError):
        split_dim(0)


@pytest.mark.parametrize("case", [
    dict(kind="lowrank"), dict(rank=-1), dict(shape=(4,)),
    dict(shape=(8, 8)), dict(basis_shape=(4, 4)), dict(delta_bits=3),
    dict(bad=np.nan), dict(bad=np.inf), dict(bad_basis=True)],
    ids=["kind", "rank", "ndim", "no_basis", "basis_shape", "bits", "nan",
         "inf", "basis_nan"])
def test_rejections_match(case):
    w = _experts(2, 3, 8, 8)
    if "shape" in case:
        w = np.ones(case["shape"], np.float32)
    if "bad" in case:
        w[1, 2, 3] = case["bad"]
    basis = None
    if "basis_shape" in case:
        basis = np.ones(case["basis_shape"], np.float32)
    if case.get("bad_basis"):
        basis = np.full((8, 8), np.nan, np.float32)
    kw = dict(rank=case.get("rank", 2), basis=basis,
              delta_bits=case.get("delta_bits"))
    kind = case.get("kind", "rank")
    with pytest.raises(ValueError):
        jfactorize(jnp.asarray(w), kind, **{
            k: (None if v is None else jnp.asarray(v)) if k == "basis"
            else v for k, v in kw.items()})
    with pytest.raises(ValueError):
        factorize(torch.from_numpy(w), kind, **{
            k: (None if v is None else torch.from_numpy(v)) if k == "basis"
            else v for k, v in kw.items()})


def _moe_dict(seed=0):
    return {"gate": np.ones((2, 8, 4), np.float32),
            "w1": _experts(seed, 4, 8, 12), "b1": np.zeros((4, 12),
                                                           np.float32),
            "w2": _experts(seed + 1, 4, 12, 8)}


def _factored_names(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out |= _factored_names(v, name)
        elif is_factored(v) or type(v).__name__ == "FactoredTensor":
            out.add(name)
    return out


@pytest.mark.parametrize("quantized", [False, True])
def test_factorize_tree_gate_sibling_rule(quantized):
    tree = {"moe": _moe_dict(),
            "mlp": {"w1": _experts(3, 2, 8, 12)},             # no gate
            "scan": {"moe": {"gate": np.zeros((2, 8, 4), np.float32),
                             "w1": np.zeros((2, 4, 8, 12), np.float32)}}}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = params_from_jax(tree, device="cpu")             # flat names
    if quantized:
        from repro.quant import quantize_tree as jquantize_tree

        jtree, ttree = jquantize_tree(jtree), quantize_tree(ttree)
    jf = jfactorize_tree(jtree, rank=2, delta_bits=8)
    tf = factorize_tree(ttree, rank=2, delta_bits=8)
    assert {k for k, v in tf.items() if is_factored(v)} \
        == _factored_names(jf) == {"moe.w1", "moe.w2"}
    _same(jf["moe"]["w1"].u, tf["moe.w1"].u)
    # nested dicts convert the same way; idempotent; names respected
    nested = factorize_tree({"moe": {k: ttree[f"moe.{k}"]
                                     for k in ("gate", "w1", "w2", "b1")}},
                            rank=2, delta_bits=8, names={"w1"})
    assert is_factored(nested["moe"]["w1"]) \
        and not is_factored(nested["moe"]["w2"])
    assert factorize_tree(tf, rank=2)["moe.w1"] is tf["moe.w1"]
    assert is_factored(quantize_tree(tf)["moe.w1"])
    rec = reconstruct_tree(factorize_tree(params_from_jax(
        {"moe": _moe_dict(3)}, device="cpu"), rank=8))
    w = _moe_dict(3)["w1"]
    assert np.linalg.norm(rec["moe.w1"].numpy() - w) / np.linalg.norm(w) \
        < 1e-4


# ========================================================= eager_factored


def _ops_pair(kind, delta_bits, e=4, k=16, n=24):
    w = _experts(0, e, k, n)
    return (jfactorize(jnp.asarray(w), kind, rank=4, delta_bits=delta_bits),
            factorize(torch.from_numpy(w), kind, rank=4,
                      delta_bits=delta_bits))


@pytest.mark.parametrize("delta_bits", [None, 8, 4])
@pytest.mark.parametrize("kind", ["rank", "butterfly"])
def test_moe_grouped_gemm_factored_matches_reference(kind, delta_bits):
    jf, tf = _ops_pair(kind, delta_bits)
    buf = np.random.default_rng(1).normal(size=(4, 6, 16)).astype(
        np.float32)
    sizes = np.array([6, 0, 3, 1], np.int32)
    with jops.use_policy(jops.policy_named("xla_factored")):
        want = np.array(jops.dispatch("moe_grouped_gemm", jnp.asarray(buf),
                                      jf, jnp.asarray(sizes)))
    ops.reset_dispatch_report()
    with ops.use_policy(ops.policy_named("eager_factored")):
        got = ops.dispatch("moe_grouped_gemm", torch.from_numpy(buf)[None],
                           tf, torch.from_numpy(sizes)[None])[0]
    assert within_tolerance(got, torch.from_numpy(want), F32)
    assert (got[1] == 0).all()
    rep = ops.dispatch_report()["moe_grouped_gemm"]
    assert rep["hits"] == {"eager_factored": 1} and not rep["fallbacks"]


@pytest.mark.parametrize("delta_bits", [None, 8, 4])
@pytest.mark.parametrize("kind", ["rank", "butterfly"])
def test_linear_factored_matches_reference(kind, delta_bits):
    w = _experts(2, 3, 16, 8)
    jf = jfactorize(jnp.asarray(w[0]), kind, rank=8,
                    basis=jnp.asarray(w.mean(0)), delta_bits=delta_bits)
    tf = factorize(torch.from_numpy(w[0]), kind, rank=8,
                   basis=torch.from_numpy(w.mean(0)), delta_bits=delta_bits)
    x = np.random.default_rng(3).normal(size=(2, 5, 16)).astype(np.float32)
    b = np.random.default_rng(4).normal(size=(8,)).astype(np.float32)
    pol = "xla_factored"
    with jops.use_policy(jops.policy_named(pol).with_impls(
            linear=pol)):
        want = np.array(jops.dispatch("linear", jnp.asarray(x), jf,
                                      jnp.asarray(b), activation="gelu"))
    with ops.use_policy(ops.policy_named("eager_factored").with_impls(
            linear="eager_factored")):
        got = ops.dispatch("linear", torch.from_numpy(x), tf,
                           torch.from_numpy(b), activation="gelu")
    assert within_tolerance(got, torch.from_numpy(want), F32,
                            lut_pre=torch.from_numpy(
                                x @ reconstruct(tf, F32).numpy() + b))


def test_factored_operands_fall_back_with_reason():
    """The default chain and the int8 impls send a FactoredTensor on to
    eager_factored with the reference's reasons, the same numbers as a
    hit."""
    _, tf = _ops_pair("rank", 8)
    buf = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 4, 6, 16)).astype(np.float32))
    ops.reset_dispatch_report()
    for policy in ("eager", "cuda", "eager_int8"):
        with ops.use_policy(ops.policy_named(policy)):
            y_fb = ops.dispatch("moe_grouped_gemm", buf, tf, None)
    (f1, f2, f3) = ops.dispatch_report()["moe_grouped_gemm"]["fallbacks"]
    fb = {f["requested"]: f for f in (f1, f2, f3)}
    assert fb["eager"]["reasons"][0] == (
        "eager: operand is factored (FactoredTensor) — served by the "
        "eager_factored impl")
    assert fb["eager_int8"]["reasons"][0] == (
        "eager_int8: expert weights are factored (FactoredTensor) — served "
        "by the eager_factored impl")
    assert all(f["used"] == "eager_factored" for f in fb.values())
    with ops.use_policy(ops.policy_named("eager_factored")):
        y_hit = ops.dispatch("moe_grouped_gemm", buf, tf, None)
    assert torch.equal(y_fb, y_hit)
    # an expert-stacked factored weight has no linear impl
    with pytest.raises(ops.DispatchError, match="per-expert axis"):
        ops.dispatch("linear", torch.ones(5, 16), tf, None)
