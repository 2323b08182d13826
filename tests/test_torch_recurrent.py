"""The port's recurrent families — xLSTM (mLSTM, sLSTM) and RG-LRU —
against the JAX reference, on the CPU, from the same NumPy inputs and
parameters.

* The pieces (``causal_conv1d``, ``group_norm``, ``_mlstm_chunk_scan`` at
  chunks 4/8/16 over a ragged S with and without a carried state,
  ``mlstm_recurrent_step``, ``_slstm_cell``, ``_rglru_scan`` with and
  without ``h0``, ``rglru_step``) in float32 within rtol/atol 1e-5.
* The blocks (``apply_mlstm``, ``apply_slstm``, ``apply_rglru``): a prefill
  from a random state, then one decode step, outputs and every state leaf;
  float32 within 1e-5 of each one's magnitude, bf16 within 2^-6 of it (a
  few bf16 roundings of the block's output, two of the state's inputs).
* ``transformer.forward`` of the xLSTM-350M and RecurrentGemma-9B
  ``SMOKE_CONFIG`` with the reference's parameters through ``bridge``:
  float32 logits within 1e-4 of their magnitude under exact activations
  (``eager`` against ``xla``); under the kernel presets (``cuda`` against
  ``pallas``, the LUT GELU in the fused epilogue) within 1e-3, since a
  pre-activation an ulp apart may round to the neighbouring table index
  (one table step, ``kernels/compare.py``'s LUT allowance).  bf16 logits
  at cosine >= 0.995 of the reference's bf16 logits and no further from
  its float32 logits than its own bf16 logits are, less 2e-3: the blocks
  agree to the bit or to 1e-7 in bf16 (above), but the xLSTM stack
  amplifies bf16 roundings — the reference's own bf16 logits sit at
  cosine 0.9979 of its float32 ones after the 7 mLSTM layers and at 0.9943
  after the sLSTM layer (the port's at 0.9978 of the reference's bf16);
  RecurrentGemma's at 0.9997.
* Prefill then decode against the reference's serve steps: the logits of
  every step (float32, 1e-4 of their magnitude) and the greedy tokens.
* ``seq_groups`` (the card's fixed-group form of the recurrences) forced
  on the CPU: the same results as the ungrouped call.
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
from repro.models import model as jmodel
from repro.models import rglru as JR
from repro.models import xlstm as JX
from repro.train.step import make_serve_step as jmake_serve_step
from repro_torch import configs as tconfigs
from repro_torch import ops
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.kernels.compare import cosine
from repro_torch.models import model as tmodel
from repro_torch.models import rglru as TR
from repro_torch.models import xlstm as TX
from repro_torch.train.step import make_serve_step
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("xlstm_350m", "recurrentgemma_9b")
POLICIES = {  # name: (JAX policy, port policy)
    "exact": (jops.policy_named("xla"), ops.policy_named("eager")),
    "kernels": (jops.policy_named("pallas").with_impls(
        attention_decode="pallas_fused"),
        ops.policy_named("cuda").with_impls(attention_decode="cuda_fused")),
}


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(_f32(got), _f32(want), **(tol or TOL))


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(rng, with_state):
    x, w = _rand(rng, 2, 7, 6), _rand(rng, 4, 6)
    st = _rand(rng, 2, 3, 6) if with_state else None
    jy, js = JX.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                              None if st is None else jnp.asarray(st))
    ty, ts = TX.causal_conv1d(_t(x), _t(w), None if st is None else _t(st))
    _close(ty, jy)
    _close(ts, js)


def test_group_norm(rng):
    x, scale = _rand(rng, 2, 5, 3, 8), _rand(rng, 3, 8)
    _close(TX.group_norm(_t(x), _t(scale)),
           JX.group_norm(jnp.asarray(x), jnp.asarray(scale)))


def _mlstm_inputs(rng, b=2, h=2, s=13, dh=8):
    q, k, v = (_rand(rng, b, h, s, dh) for _ in range(3))
    logi = _rand(rng, b, h, s)
    logf = np.log(1 / (1 + np.exp(-_rand(rng, b, h, s) - 3))).astype(
        np.float32)
    state = (_rand(rng, b, h, dh, dh, scale=0.1), _rand(rng, b, h, dh),
             _rand(rng, b, h))
    return q, k, v, logi, logf, state


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_chunk_scan(rng, chunk, carried):
    """S = 13: a ragged last chunk at 4 and 8, one padded chunk at 16."""
    q, k, v, logi, logf, state = _mlstm_inputs(rng)
    st = state if carried else None
    jh, js = jax.jit(JX._mlstm_chunk_scan, static_argnums=6)(
        *map(jnp.asarray, (q, k, v, logi, logf)),
        None if st is None else tuple(map(jnp.asarray, st)), chunk)
    th, ts = TX._mlstm_chunk_scan(
        *map(_t, (q, k, v, logi, logf)),
        None if st is None else tuple(map(_t, st)), chunk)
    _close(th, jh)
    for a, b in zip(ts, js):
        _close(a, b)


def test_mlstm_recurrent_step(rng):
    q, k, v, logi, logf, state = _mlstm_inputs(rng, s=1)
    args = [a[:, :, 0] for a in (q, k, v)] + [logi[..., 0], logf[..., 0]]
    jh, js = JX.mlstm_recurrent_step(*map(jnp.asarray, args),
                                     tuple(map(jnp.asarray, state)))
    th, ts = TX.mlstm_recurrent_step(*map(_t, args), tuple(map(_t, state)))
    _close(th, jh)
    for a, b in zip(ts, js):
        _close(a, b)


def test_slstm_cell(rng):
    wx, r = _rand(rng, 2, 3, 4, 4), _rand(rng, 3, 4, 16, scale=0.5)
    state = tuple(_rand(rng, 2, 3, 4) for _ in range(4))
    state = (state[0], np.abs(state[1]) + 0.5, state[2], state[3])
    (jst, jh) = JX._slstm_cell(jnp.asarray(wx), jnp.asarray(r),
                               tuple(map(jnp.asarray, state)))
    (tst, th) = TX._slstm_cell(_t(wx), _t(r), tuple(map(_t, state)))
    _close(th, jh)
    for a, b in zip(tst, jst):
        _close(a, b)


def _rglru_inputs(rng, b=2, s=37, w=6):
    x = _rand(rng, b, s, w)
    r, i = (1 / (1 + np.exp(-_rand(rng, b, s, w)))).astype(np.float32), \
        (1 / (1 + np.exp(-_rand(rng, b, s, w)))).astype(np.float32)
    lam = _rand(rng, w)
    return x, r, i, lam, _rand(rng, b, w)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan(rng, with_h0):
    """37 steps: six doubling passes, the last reaching past the middle."""
    x, r, i, lam, h0 = _rglru_inputs(rng)
    h0 = h0 if with_h0 else None
    _close(TR._rglru_scan(*map(_t, (x, r, i, lam)),
                          None if h0 is None else _t(h0)),
           jax.jit(JR._rglru_scan)(*map(jnp.asarray, (x, r, i, lam)),
                                   None if h0 is None else jnp.asarray(h0)))


def test_rglru_step(rng):
    x, r, i, lam, h0 = _rglru_inputs(rng, s=1)
    args = (x[:, 0], r[:, 0], i[:, 0], lam, h0)
    _close(TR.rglru_step(*map(_t, args)),
           JR.rglru_step(*map(jnp.asarray, args)))


# ------------------------------------------------------------ the blocks

BLOCKS = {  # name: (arch, JAX init, JAX apply, port apply, port state init)
    "mlstm": ("xlstm_350m", JX.init_mlstm, JX.apply_mlstm, TX.apply_mlstm,
              TX.init_mlstm_state),
    "slstm": ("xlstm_350m", JX.init_slstm, JX.apply_slstm, TX.apply_slstm,
              TX.init_slstm_state),
    "rglru": ("recurrentgemma_9b", JR.init_rglru, JR.apply_rglru,
              TR.apply_rglru, TR.init_rglru_state),
}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_apply_block_prefill_then_decode(rng, block, dtype):
    """A 13-token prefill from a random state (written in place into the
    port's state tensors), then one decode step from the result."""
    arch, jinit, japply, tapply, tinit = BLOCKS[block]
    jcfg = replace(jconfigs.get(arch, smoke=True), dtype=dtype)
    tcfg = replace(tconfigs.get(arch, smoke=True), dtype=dtype)
    jdt = jnp.dtype(dtype)
    params = jax.device_get(jinit(jax.random.PRNGKey(1), jcfg, jdt))
    tparams = {k: _t(v) for k, v in params.items()}
    tstate = tinit(tcfg, 2)
    jstate = {}
    for k, leaf in tstate.items():
        a = _rand(rng, *leaf.shape, scale=0.5)
        if k in ("n",) and block == "slstm":
            a = np.abs(a) + 0.5
        jstate[k] = jnp.asarray(a, jnp.dtype(str(leaf.dtype)[6:]))
        leaf.copy_(_t(np.asarray(jstate[k])))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    japply = jax.jit(japply, static_argnums=(2, 4))
    for s, decode in ((13, False), (1, True)):
        x = _rand(rng, 2, s, jcfg.d_model)
        xj = jnp.asarray(x, jdt)
        jy, jstate = japply(params, xj, jcfg, jstate, decode)
        ty, same = tapply(tparams, _t(np.asarray(xj)), tcfg, tstate, decode)
        assert same is tstate
        assert _rel(ty, jy) <= tol, (s, _rel(ty, jy))
        for k in jstate:
            assert tstate[k].dtype == (tcfg.activation_dtype if k == "conv"
                                       else torch.float32), k
            assert _rel(tstate[k], jstate[k]) <= tol, (s, k)


# ------------------------------------------------------------ the models


def _jforward(jparams, tokens, jcfg):
    """The reference's logits, jitted (one compile per config)."""
    fn = jax.jit(functools.partial(jmodel.forward, cfg=jcfg))
    return np.asarray(fn(jparams, jnp.asarray(tokens))[0], np.float32)


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    """The reference's parameters from key 0 as a NumPy tree: drawn once
    in float32; a bf16 tree rounds the leaves the bf16 init stores in bf16
    (its values are those draws, rounded)."""
    cfg = replace(jconfigs.get(arch, smoke=True), dtype=dtype)
    init = functools.partial(jmodel.init_params, cfg=cfg)
    if dtype == "float32":
        return jax.device_get(init(jax.random.PRNGKey(0)))
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a, sd: np.asarray(a).astype(sd.dtype),
                        _params(arch, "float32"), shapes)


@functools.lru_cache(maxsize=None)
def _model(arch, dtype, policy):
    jpol, tpol = POLICIES[policy]
    jcfg = replace(jconfigs.get(arch, smoke=True), dtype=dtype, policy=jpol)
    tcfg = replace(tconfigs.get(arch, smoke=True), dtype=dtype, policy=tpol)
    jparams = _params(arch, dtype)
    return jcfg, tcfg, jparams, params_from_jax(jparams, device="cpu")


TOKENS = np.random.default_rng(5).integers(0, 128, (2, 21)).astype(np.int32)


@pytest.mark.parametrize("dtype, policy", [("float32", "exact"),
                                           ("float32", "kernels"),
                                           ("bfloat16", "kernels")])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype, policy):
    jcfg, tcfg, jparams, tparams = _model(arch, dtype, policy)
    want = _jforward(jparams, TOKENS, jcfg)
    with torch.inference_mode():
        got, state, _ = tmodel.forward(tparams,
                                       torch.from_numpy(TOKENS).long(), tcfg)
    assert state is None and got.dtype == torch.float32
    assert got.shape == want.shape == (2, 21, 128)
    if dtype == "bfloat16":
        jf32, _, jp32, _ = _model(arch, "float32", policy)
        exact = torch.from_numpy(_jforward(jp32, TOKENS, jf32))
        want = torch.from_numpy(want)
        assert cosine(got, want) >= 0.995
        assert cosine(got, exact) >= cosine(want, exact) - 2e-3
    else:
        assert _rel(got, want) <= (1e-4 if policy == "exact" else 1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    """The serve steps (prefill into a fresh state, then 4 greedy decode
    steps) under the exact presets: every step's logits and token."""
    jcfg, tcfg, jparams, tparams = _model(arch, "float32", "exact")
    jprefill, jdecode = jmake_serve_step(jcfg)
    prefill, decode = make_serve_step(tcfg)
    jstate = jmodel.init_state(jcfg, 2, 32)
    tstate = tmodel.init_state(tcfg, 2, 32, device="cpu")
    jl, jstate = jprefill(jparams, jnp.asarray(TOKENS[:, :9]), jstate)
    with torch.inference_mode():
        tl, tstate = prefill(tparams, torch.from_numpy(TOKENS[:, :9]).long(),
                             tstate)
        for i in range(5):
            jl = np.asarray(jl)
            assert _rel(tl, jl) <= 1e-4, i
            tok = jl.argmax(-1)
            assert (tl.argmax(-1).numpy() == tok).all(), i
            if i == 4:
                break
            jl, jstate = jdecode(jparams, jnp.asarray(tok[:, None]), jstate,
                                 jnp.int32(9 + i))
            tl, tstate = decode(tparams, torch.from_numpy(tok[:, None]),
                                tstate, 9 + i)


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_groups_give_the_ungrouped_results(arch, monkeypatch):
    """The card's form of the recurrences (groups of 8 sequences, zero
    padded), forced on the CPU at a batch of 3: the same logits and
    states as the ungrouped call."""
    _, tcfg, _, tparams = _model(arch, "float32", "exact")
    toks = torch.from_numpy(np.concatenate([TOKENS, TOKENS[:1]])).long()

    def run():
        state = tmodel.init_state(tcfg, 3, 32, device="cpu")
        with torch.inference_mode():
            logits, _, _ = tmodel.forward(tparams, toks, tcfg, state=state,
                                          cache_index=0)
        return logits, state

    want, wstate = run()
    calls = []
    monkeypatch.setattr(TX, "_grouped", lambda t: calls.append(1) or True)
    got, gstate = run()
    assert calls
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for (k, a), b in zip(sorted(_flat(gstate).items()),
                         [v for _, v in sorted(_flat(wstate).items())]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=k)


def _flat(state):
    from repro_torch.tree import flatten

    return flatten(state)


@pytest.mark.parametrize("cosines, ok", [
    (([0.9995, 0.9992], None, None), True),         # the cosine target met
    (([0.98, 0.98], [0.9596, 0.97], [0.9622, 0.97]), True),   # ratio 1.07
    (([0.98, 0.98], [0.90, 0.97], [0.96, 0.97]), False),      # ratio 2.5
    (([0.98], None, None), False),                   # no float32 reading
], ids=["cosine", "noise_ratio", "too_far", "no_yardstick"])
def test_serving_rule(cosines, ok):
    """``compare.serving_agrees``, the rule of ``chip_smoke.py`` phase 7:
    cosine >= 0.999 to the plain policy at every step, or the kernels'
    distance from the float32 logits within 1.25x the plain policy's +
    1e-3."""
    from repro_torch.kernels.compare import serving_agrees

    assert serving_agrees(*cosines) is ok
