"""The paper's technique entry points, by the reference's names
(``examples/quickstart.py``), against the reference on the same inputs.

* ① Table II's model of the attention reordering: ``BandwidthModel`` /
  ``bandwidth_model`` — every field equal, over a grid of N and p.
* ② The single-pass softmax: ``online_max_sum``, ``merge_stats``,
  ``online_max_sum_blocked`` and ``softmax(..., block=)`` — float32,
  within 1e-6 relative (the same sums in another order); every form
  stays finite where ``exp`` overflows (``[88, 90, 7, -3]``), equal to
  the reference there, and at empty (-inf) sides ``merge_stats`` gives
  the reference's zeros.
* ③ ``build_delta_table`` bit for bit; ``lut_gelu``, ``lut_silu`` and
  ``get_activation`` within ``LUT_BOUND`` (5e-4, ``test_torch_m3vit.py``)
  of the reference's (exact forms within 1e-5: the two libraries'
  float32 sigmoid differ by 1e-6 around -12).
* ④ ``sparse_linear``, ``Linear.apply`` on the same parameters and the
  ``Linear`` module: float32, within 1e-5.
* ``replace_impl``; ``registered``, ``op_names``, ``capability_matrix``
  and ``default_impl`` under the impl-name mapping (``xla`` → ``eager``,
  ``pallas`` → ``cuda``, ``pallas_fused`` → ``cuda_fused``, ``xla_int8``
  → ``eager_int8``, ``xla_factored`` → ``eager_factored``); the port's
  ``ops.impls.apply_activation`` against the reference's under the
  ``xla``/``eager`` presets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JAtt
from repro.core import gelu as JG
from repro.core import moe as JMoE
from repro.core import online_softmax as JOS
from repro.core import unified_linear as JUL
from repro.ops import impls as JImpls
from repro.ops import registry as JReg
from repro.ops.policy import policy_named as jpolicy_named
from repro.ops.policy import use_policy as juse_policy
from repro_torch import ops
from repro_torch.core import attention as TAtt
from repro_torch.core import gelu as TG
from repro_torch.core import moe as TMoE
from repro_torch.core import online_softmax as TOS
from repro_torch.core import unified_linear as TUL
from repro_torch.ops import impls as TImpls
from repro_torch.ops import registry as TReg
from test_torch_threads import one_torch_thread  # noqa: F401

LUT_BOUND = 5e-4      # tests/test_torch_m3vit.py
IMPL_NAMES = {"xla": "eager", "pallas": "cuda", "pallas_fused": "cuda_fused",
              "xla_int8": "eager_int8", "xla_factored": "eager_factored",
              "lut": "lut", "blocked": "blocked", "ref": "ref"}


def _x(*shape, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol)


# ------------------------------------------------------------ ① Table II


@pytest.mark.parametrize("n", [128, 197, 1024])
@pytest.mark.parametrize("p", [1, 4, 8, 16])
def test_bandwidth_model_equals_the_reference(n, p):
    want, got = JAtt.bandwidth_model(n, p), TAtt.bandwidth_model(n, p)
    for name in ("loads_without_reorder", "loads_with_reorder",
                 "latency_without_reorder", "latency_with_reorder",
                 "bandwidth_without_reorder", "bandwidth_with_reorder"):
        assert getattr(got, name) == getattr(want, name), name
    assert isinstance(got, TAtt.BandwidthModel)


# ---------------------------------------------------- ② one-pass softmax


@pytest.mark.parametrize("shape,dim", [((37,), -1), ((4, 300), -1),
                                       ((300, 3), 0)])
def test_online_statistics_equal_the_reference(shape, dim):
    x = _x(*shape, seed=len(shape))
    jb, js = JOS.online_max_sum(jnp.asarray(x), axis=dim)
    tb, ts = TOS.online_max_sum(torch.from_numpy(x), dim=dim)
    _close(tb, jb, 1e-6)
    _close(ts, js, 1e-6)
    for block in (7, 64, 128):
        jb, js = JOS.online_max_sum_blocked(jnp.asarray(x), axis=dim,
                                            block=block)
        tb, ts = TOS.online_max_sum_blocked(torch.from_numpy(x), dim=dim,
                                            block=block)
        _close(tb, jb, 1e-6)
        _close(ts, js, 1e-6)


@pytest.mark.parametrize("block", [None, 3, 128])
def test_softmax_equals_the_reference(block):
    x = _x(5, 200, seed=3)
    where = _x(5, 200, seed=4) > -1.0
    for w in (None, where):
        want = JOS.softmax(jnp.asarray(x), axis=-1,
                           where=None if w is None else jnp.asarray(w),
                           block=block)
        got = TOS.softmax(torch.from_numpy(x), dim=-1,
                          where=None if w is None else torch.from_numpy(w),
                          block=block)
        _close(got, want, 1e-6)


def test_softmax_stays_finite_where_exp_overflows():
    x = np.array([88.0, 90.0, 7.0, -3.0], np.float32)
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.exp(x[1]))
    tb, ts = TOS.online_max_sum(torch.from_numpy(x))
    jb, js = JOS.online_max_sum(jnp.asarray(x))
    assert torch.isfinite(ts) and float(tb) == 90.0
    _close(ts, js, 1e-6)
    for block in (None, 2, 3):
        got = TOS.softmax(torch.from_numpy(x), block=block)
        assert torch.isfinite(got).all()
        _close(got, JOS.softmax(jnp.asarray(x), block=block), 1e-6)
        assert abs(float(got.sum()) - 1.0) < 1e-6


def test_merge_stats_equals_the_reference():
    m_a, s_a = _x(64, seed=5), np.abs(_x(64, seed=6))
    m_b, s_b = _x(64, seed=7), np.abs(_x(64, seed=8))
    m_a[:8] = -np.inf
    s_a[:8] = 0.0
    m_b[4:12] = -np.inf
    s_b[4:12] = 0.0
    jm, js = JOS.merge_stats(*(jnp.asarray(a) for a in (m_a, s_a, m_b, s_b)))
    tm, ts = TOS.merge_stats(*(torch.from_numpy(a)
                               for a in (m_a, s_a, m_b, s_b)))
    np.testing.assert_array_equal(np.asarray(tm), np.asarray(jm))
    _close(ts, js, 1e-6)
    assert (ts[4:8] == 0).all()         # both sides empty


# ------------------------------------------------------------- ③ the LUT


@pytest.mark.parametrize("kind", ["gelu", "silu"])
@pytest.mark.parametrize("step_log2", [-8, -6])
def test_delta_table_bit_equal(kind, step_log2):
    want = np.asarray(JG.build_delta_table(kind, step_log2, 8.0))
    got = TG.build_delta_table(kind, step_log2, 8.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert TG.build_delta_table(kind, step_log2, 8.0,
                                dtype=torch.float64).dtype == torch.float64


def test_lut_names_equal_the_reference():
    x = _x(4096, seed=9)
    x[:4] = [0.0, -0.0, 7.99, -12.0]
    for name in ("lut_gelu", "lut_silu"):
        _close(getattr(TG, name)(torch.from_numpy(x)),
               getattr(JG, name)(jnp.asarray(x)), LUT_BOUND)
    for name in ("relu", "gelu", "silu", None, "identity"):
        for use_lut in (False, True):
            want = JG.get_activation(name, use_lut)(jnp.asarray(x))
            got = TG.get_activation(name, use_lut)(torch.from_numpy(x))
            _close(got, want, LUT_BOUND if use_lut else 1e-5)
    with pytest.raises(ValueError):
        TG.get_activation("tanh")


# ---------------------------------------------------- ④ the unified linear


def test_sparse_linear_and_linear_equal_the_reference():
    x, w, b = _x(3, 40, 64, seed=10), _x(64, 96, seed=11, scale=0.1), \
        _x(96, seed=12)
    idx = np.array([0, 5, 5, 39, 17], np.int64)
    with juse_policy(jpolicy_named("xla")):
        want = JUL.sparse_linear(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), jnp.asarray(idx),
                                 activation="relu")
        want_lin = JUL.Linear.apply({"w": jnp.asarray(w),
                                     "b": jnp.asarray(b)}, jnp.asarray(x))
    with ops.use_policy(ops.policy_named("eager")):
        got = TUL.sparse_linear(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), torch.from_numpy(idx),
                                activation="relu")
        params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
        got_lin = TUL.Linear.apply(params, torch.from_numpy(x))
        mod = TUL.Linear(64, 96, dtype=torch.float32, seed=1, device="cpu")
        p = TUL.Linear.init(np.random.default_rng(1), 64, 96,
                            dtype=torch.float32)
        with torch.no_grad():
            mod_out = mod(torch.from_numpy(x))
            init_out = TUL.Linear.apply(p, torch.from_numpy(x))
    _close(got, want, 1e-5)
    _close(got_lin, want_lin, 1e-5)
    assert torch.equal(mod_out, init_out)
    assert mod.w.shape == (64, 96) and mod.b.dtype == torch.float32
    assert abs(float(p["w"].std()) - 1 / 8) < 0.01


# ------------------------------------------------------- moe and registry


def test_replace_impl():
    cfg = TMoE.MoEConfig(d_model=8, d_ff=16, num_experts=4, top_k=2)
    got = TMoE.replace_impl(cfg, "onehot")
    want = JMoE.replace_impl(JMoE.MoEConfig(d_model=8, d_ff=16,
                                            num_experts=4, top_k=2),
                             "onehot")
    assert got.impl == want.impl == "onehot" and cfg.impl == "grouped"


def test_registry_introspection_under_the_name_mapping():
    assert TReg.op_names() == JReg.op_names()
    jmat, tmat = JReg.capability_matrix(), TReg.capability_matrix()
    assert list(tmat) == list(jmat)
    for op in jmat:
        assert sorted(tmat[op]) == sorted(IMPL_NAMES[n] for n in jmat[op])
        assert all(doc for doc in tmat[op].values()), op
        assert TReg.default_impl(op) == IMPL_NAMES[JReg.default_impl(op)]
        assert sorted(TReg.registered(op)) == sorted(tmat[op])
    with pytest.raises(KeyError):
        TReg.registered("no_such_op")


@pytest.mark.parametrize("kind", ["relu", "gelu", "silu", None, "none"])
def test_apply_activation_equals_the_reference(kind):
    x = _x(256, seed=13)
    with juse_policy(jpolicy_named("xla")):
        want = JImpls.apply_activation(jnp.asarray(x), kind)
    with ops.use_policy(ops.policy_named("eager")):
        got = TImpls.apply_activation(torch.from_numpy(x), kind)
    _close(got, want, 1e-6)


def test_linear_module_defaults_to_the_card():
    """A new entry point: the card by default, and no silent CPU fallback
    on a machine without one."""
    import inspect

    assert inspect.signature(TUL.Linear).parameters["device"].default \
        == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TUL.Linear(8, 4)
