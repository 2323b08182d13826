"""The port's four examples (``repro_torch.examples``) against the JAX
package's ``examples/*.py``, on the CPU, and the two names the port's
``ops.policy`` adds (``OPS``, ``ComputePolicy.with_options``).

The reference examples are loaded by path and left as they are; where a
test needs their values it patches names of the loaded module (its
config getter, ``jax.jit`` to record a jitted call's outputs, its
``TrainLoop`` to keep the loop) and sets ``sys.argv`` for their parsers.
Reference weights come across through ``bridge.params_from_jax``.

Tolerances, each stated where it is used:

* quickstart ①–⑤ on the same NumPy inputs: integers (loads, table size,
  queue sizes) equal; max|Δ|, the softmax bias and denominator and the
  LUT's max error within 1e-6 absolute; ④'s output within one LUT table
  step (2^-8 × the largest |GELU'| = 1.13) plus float32 1e-5 relative of
  the reference's, since the port's epilogue and XLA's may round the
  pre-activation to either side of a table index; M³ViT at the paper
  config (float32, so the bound is not bf16 noise) within ``LUT_BOUND``
  × the output's max magnitude (``tests/test_torch_m3vit.py``);
* multitask_vit (smoke config, float32, 3 steps, the same stream
  batches): each step's semseg and depth loss within 1e-4 relative of
  the reference's jitted step; the demo's semseg argmax equal on
  >= 99.9 % of pixels;
* serve_lm (each smoke config, float32): greedy tokens equal to the
  reference engine's on the same weights and prompts; the decode state's
  bytes (at the config's own dtype) equal to the reference's
  ``init_state``;
* train_lm: ``lm_100m()`` equal field for field and ``param_count`` equal;
  at a reduced config (2 layers, d 64, 4 heads of 16, vocab 512) 4 steps'
  losses within 1e-4 relative of the reference's loop (bf16, the
  config's dtype; the LM train-step test's bound); a run stopped after
  its step-2 checkpoint and relaunched resumes at step 2 and ends
  bit-equal to the uninterrupted run.
"""

import dataclasses
import importlib.util
import sys
import types
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import attention as jattention
from repro.core import gelu as jgelu
from repro.core import online_softmax as jsoftmax
from repro.core import routing as jrouting
from repro.core.unified_linear import unified_linear as junified_linear
from repro.models import model as JM
from repro.models import vit as jvit
from repro.ops import policy as jpolicy
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get
from repro_torch.examples import multitask_vit, quickstart, serve_lm, \
    train_lm
from repro_torch.models import model as TM
from repro_torch.ops import policy as tpolicy
from test_torch_m3vit import LUT_BOUND
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {"quickstart": quickstart, "multitask_vit": multitask_vit,
            "serve_lm": serve_lm, "train_lm": train_lm}


def _reference(name):
    """The JAX package's ``examples/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host(tree):
    return params_from_jax(jax.device_get(tree), device="cpu")


# ---------------------------------------------------------------- policy


def test_ops_tuple_matches_reference():
    assert tpolicy.OPS == jpolicy.OPS
    assert "OPS" in tpolicy.__all__
    from repro_torch import ops
    assert ops.OPS is tpolicy.OPS


OPTIONS = [dict(lut_step_log2=-7, bias_f32=False),
           dict(accum_dtype="bfloat16", lut_range=4.0)]


@pytest.mark.parametrize("kw", OPTIONS, ids=lambda kw: ",".join(kw))
def test_with_options_replaces_fields(kw):
    base = tpolicy.policy_named("cuda").with_tiles("attention", block_k=64)
    got = base.with_options(**kw)
    assert got == dataclasses.replace(base, **kw)
    want = jpolicy.ComputePolicy().with_options(**kw)
    mine = tpolicy.ComputePolicy().with_options(**kw)
    names = {f.name for f in dataclasses.fields(tpolicy.ComputePolicy)}
    # the Pallas interpret switch has no counterpart: the operands' device
    # decides where a kernel impl runs
    assert {f.name for f in dataclasses.fields(jpolicy.ComputePolicy)} \
        - names == {"interpret"}
    for name in names:
        assert getattr(mine, name) == getattr(want, name), name


# ---------------------------------------------------------------- quickstart


@pytest.fixture(scope="module")
def quick():
    return quickstart.main(["--device", "cpu"])


@pytest.fixture(scope="module")
def quick_reference():
    """①–⑤ through the reference's functions on the reference script's
    NumPy inputs (``default_rng(0)``, drawn in its order)."""
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.normal(size=(1, 4, 128, 64)), jnp.float32)
               for _ in range(3))
    diff = float(jnp.abs(
        jattention.naive_attention(q, k, v, causal=False)
        - jattention.blocked_attention(q, k, v, causal=False,
                                       block_k=32)).max())
    m = jattention.bandwidth_model(n=128, p=4)
    b, s = jsoftmax.online_max_sum(jnp.asarray([88.0, 90.0, 7.0, -3.0],
                                               jnp.float32))
    xs = jnp.asarray(np.linspace(-8, 8, 100001), jnp.float32)
    err = float(jnp.abs(jgelu.lut_gelu(xs) - jgelu.exact_gelu(xs)).max())
    xw = jnp.asarray(rng.normal(size=(128, 192)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(192, 768)), jnp.float32)
    y = np.asarray(junified_linear(xw, w, activation="gelu"))
    logits = jnp.asarray(rng.normal(size=(128, 16)), jnp.float32)
    r = jrouting.route(logits, k=4, capacity=64)
    sizes = np.bincount(np.asarray(r.expert).ravel(), minlength=16)
    return {"attn_max_diff": diff,
            "loads": (m.loads_without_reorder, m.loads_with_reorder),
            "bandwidth": (m.bandwidth_without_reorder,
                          m.bandwidth_with_reorder),
            "softmax_bias": float(b), "softmax_denom": float(s),
            "lut_entries": int(jgelu.build_delta_table("gelu").shape[0]),
            "lut_max_err": err, "linear_out": y,
            "queue_sizes": sizes.tolist(),
            "empty_queues": int((sizes == 0).sum())}


EXACT_KEYS = ("loads", "lut_entries", "queue_sizes", "empty_queues")
CLOSE_KEYS = ("attn_max_diff", "softmax_bias", "softmax_denom",
              "lut_max_err")


@pytest.mark.parametrize("key", EXACT_KEYS + CLOSE_KEYS + ("bandwidth",))
def test_quickstart_technique_matches_reference(quick, quick_reference, key):
    got, want = quick[key], quick_reference[key]
    if key in EXACT_KEYS:
        assert got == want
    elif key == "bandwidth":
        assert got == pytest.approx(want, rel=1e-12)
    else:
        assert abs(got - want) <= 1e-6, (got, want)


def test_quickstart_softmax_and_linear(quick, quick_reference):
    assert quick["softmax_matches"]
    got = quick["linear_out"].numpy()
    want = quick_reference["linear_out"]
    assert quick["linear_shape"] == want.shape == (128, 768)
    # one LUT table step at GELU's steepest slope, plus float32 rounding
    bound = 2.0 ** -8 * 1.13 + 1e-5 * np.abs(want)
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.fixture(scope="module")
def m3vit_paper_float32():
    jcfg = replace(jconfigs.get("m3vit"), dtype="float32")
    tcfg = replace(get("m3vit"), dtype="float32",
                   policy=tpolicy.policy_named("cuda"))
    # jitted: the same weights as an eager init would give are not needed,
    # only the same weights on both sides (4 s against 8 s eager)
    jparams = jax.jit(jvit.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = _host(jparams)
    img = quickstart.m3vit_frame("cpu")
    got = quickstart.m3vit_tasks(tparams, img, tcfg, torch.device("cpu"))
    return jcfg, jparams, img, got


@pytest.mark.parametrize("task", quickstart.TASKS)
def test_quickstart_m3vit_matches_reference(m3vit_paper_float32, task):
    jcfg, jparams, img, got = m3vit_paper_float32
    want = np.asarray(jvit.forward(jparams, jnp.asarray(img.numpy()), jcfg,
                                   task)[0])
    pred = got[task][0].numpy()
    assert pred.shape == want.shape
    assert np.isfinite(pred).all()
    assert np.abs(pred - want).max() <= LUT_BOUND * np.abs(want).max()


# ---------------------------------------------------------------- multitask

MT_STEPS, MT_FRAMES = 3, 2


@pytest.fixture(scope="module")
def multitask_pair():
    """(the port's run, the reference's recorded jitted outputs) at the
    smoke config in float32, from the reference's initial weights."""
    ref = _reference("multitask_vit")
    recorded = []

    def jit(fn):
        compiled = jax.jit(fn)

        def call(*a):
            out = compiled(*a)
            recorded.append(out)
            return out
        return call

    def smoke_float32(name, smoke=False):
        return replace(jconfigs.get(name, smoke=smoke), dtype="float32")

    argv = ["--smoke", "--steps", str(MT_STEPS), "--frames", str(MT_FRAMES)]
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(ref, "jax", types.SimpleNamespace(
            jit=jit, block_until_ready=jax.block_until_ready,
            random=jax.random, value_and_grad=jax.value_and_grad))
        m.setattr(ref, "configs", types.SimpleNamespace(get=smoke_float32))
        m.setattr(sys, "argv", ["multitask_vit.py"] + argv)
        ref.main()
    jcfg = smoke_float32("m3vit", smoke=True)
    start = _host(jvit.init_params(jax.random.PRNGKey(0), jcfg))
    args = multitask_vit.parser().parse_args(argv + ["--device", "cpu"])
    cfg = replace(multitask_vit.config(args), dtype="float32")
    got = multitask_vit.run(args, cfg, torch.device("cpu"), params=start)
    return got, recorded


@pytest.mark.parametrize("step", range(MT_STEPS))
def test_multitask_step_losses_match_reference(multitask_pair, step):
    got, recorded = multitask_pair
    steps = [r for r in recorded if isinstance(r, tuple) and len(r) == 4]
    assert len(steps) == MT_STEPS
    _, _, ls, ld = steps[step]
    assert got["losses"][step][0] == pytest.approx(float(ls), rel=1e-4)
    assert got["losses"][step][1] == pytest.approx(float(ld), rel=1e-4)


def test_multitask_demo_agrees_with_reference(multitask_pair):
    got, recorded = multitask_pair
    want = np.asarray(jnp.argmax(recorded[-1], -1))     # the acc's forward
    assert got["pred"].shape == want.shape
    assert (got["pred"] == want).mean() >= 0.999
    assert all(len(ts) == MT_FRAMES // 2 for ts in got["frame_s"].values())
    assert got["same_storage"] and got["same_memory"] is None
    assert 0.0 <= got["accuracy"] <= 1.0


# ---------------------------------------------------------------- serve_lm

SERVE_TOKENS, SERVE_BATCH = 24, 4


@pytest.mark.parametrize("arch", serve_lm.ARCHS)
def test_serve_lm_tokens_and_state_match_reference(arch):
    def reference_bytes(cfg):
        state = JM.init_state(cfg, SERVE_BATCH, serve_lm.MAX_LEN)
        return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(state))

    jcfg = jconfigs.get(arch, smoke=True)
    tcfg = get(arch, smoke=True)
    assert serve_lm.state_bytes(tcfg, SERVE_BATCH) == reference_bytes(jcfg)

    jcfg, tcfg = (replace(c, dtype="float32") for c in (jcfg, tcfg))
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    prompts = serve_lm.prompts_for(tcfg, SERVE_BATCH)
    want = np.asarray(JServingEngine(
        jcfg, jparams, JServeConfig(max_len=serve_lm.MAX_LEN)).generate(
        jnp.asarray(prompts.numpy()), SERVE_TOKENS))
    args = serve_lm.parser().parse_args(["--device", "cpu"])
    policy = serve_lm.serve_policy(args)
    got = serve_lm.serve_arch(replace(tcfg, policy=policy), _host(jparams),
                              prompts, SERVE_TOKENS, policy,
                              torch.device("cpu"))
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["state_bytes"] == reference_bytes(jcfg)      # on the CPU
    assert got["kind"] == ("KV cache" if arch == "llama3_2_1b"
                           else "recurrent state")


# ---------------------------------------------------------------- train_lm

REDUCED = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
               head_dim=16, d_ff=256, vocab_size=512)
TRAIN_ARGS = ["--steps", "4", "--batch", "4", "--seq-len", "32"]


def test_lm_100m_matches_reference():
    want = _reference("train_lm").lm_100m()
    got = train_lm.lm_100m()
    for f in dataclasses.fields(want):
        if f.name == "policy":
            assert got.policy is None and want.policy is None
            continue
        w, g = getattr(want, f.name), getattr(got, f.name)
        if dataclasses.is_dataclass(w):
            w, g = dataclasses.asdict(w), dataclasses.asdict(g)
        assert g == w, f.name


def test_lm_100m_param_count_matches_reference():
    want = _reference("train_lm").lm_100m()
    got = train_lm.lm_100m()
    assert got.param_count() == want.param_count()
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   want))
    leaves = sum(x.size for x in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in TM.param_specs(got).values()) == leaves


_LM_100M = train_lm.lm_100m        # before any test patches it


def _reduced_port():
    return replace(_LM_100M(), **REDUCED)


def test_train_lm_losses_match_reference(tmp_path):
    ref = _reference("train_lm")
    jcfg = replace(ref.lm_100m(), **REDUCED)
    loops = []

    class Recorded(ref.TrainLoop):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loops.append(self)

    with pytest.MonkeyPatch().context() as m:
        m.setattr(ref, "lm_100m", lambda: jcfg)
        m.setattr(ref, "TrainLoop", Recorded)
        m.setattr(sys, "argv", ["train_lm.py", *TRAIN_ARGS, "--ckpt-dir",
                                str(tmp_path / "reference")])
        ref.main()
    want = loops[0].state.history
    start = _host(JM.init_params(jax.random.PRNGKey(0), jcfg))
    args = train_lm.parser().parse_args(
        TRAIN_ARGS + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    loop = train_lm.build_loop(args, _reduced_port(), torch.device("cpu"),
                               params=start)
    got = loop.run().history
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2, 3]
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, rel=1e-4)


class _KilledAt:
    """The stream, raising at ``step``'s batch: the process dies there."""

    def __init__(self, stream, step):
        self.stream, self.step = stream, step

    def batch(self, step):
        if step == self.step:
            raise KeyboardInterrupt(f"killed at step {step}")
        return self.stream.batch(step)


def test_train_lm_resumes_bit_equal(tmp_path):
    cfg, cpu = _reduced_port(), torch.device("cpu")

    def loop_in(d, params=None):
        args = train_lm.parser().parse_args(
            TRAIN_ARGS + ["--device", "cpu", "--ckpt-dir", str(d)])
        return train_lm.build_loop(args, cfg, cpu, params=params,
                                   ckpt_every=2)

    whole = loop_in(tmp_path / "whole")
    st_whole = whole.run()
    killed = loop_in(tmp_path / "killed")
    killed.stream = _KilledAt(killed.stream, 2)
    with pytest.raises(KeyboardInterrupt):
        killed.run()
    killed.ckpt.wait()
    junk = TM.init_params(99, cfg, device="cpu")
    again = loop_in(tmp_path / "killed", params=junk)
    assert again.try_restore()
    assert again.state.step == 2
    st = again.run()
    assert st.history == st_whole.history[2:]
    assert killed.state.history == st_whole.history[:2]
    for k, v in whole.params.items():
        assert torch.equal(again.params[k], v), k


# ---------------------------------------------------------------- all four


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_main_refuses_a_missing_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EXAMPLES[name].main([])


def test_quickstart_main_on_cpu(quick):
    assert set(quick["m3vit"]) == set(quickstart.TASKS)
    assert quick["m3vit"]["semseg"].shape == (1, 128, 256, 19)
    assert quick["m3vit"]["depth"].shape == (1, 128, 256)
    assert all(torch.isfinite(y).all() for y in quick["m3vit"].values())


def test_multitask_main_on_cpu():
    out = multitask_vit.main(["--device", "cpu", "--smoke", "--steps", "2",
                              "--frames", "2"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["same_storage"]


def test_serve_lm_main_on_cpu():
    out = serve_lm.main(["--device", "cpu", "--tokens", "3", "--batch", "2"])
    assert list(out) == list(serve_lm.ARCHS)
    for r in out.values():
        assert r["tokens"].shape == (2, 3) and r["tok_per_s"] > 0


def test_train_lm_main_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(train_lm, "lm_100m", _reduced_port)
    out = train_lm.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                         "--seq-len", "16", "--ckpt-dir", str(tmp_path)])
    assert out["step"] == 2 and len(out["history"]) == 2
    assert out["params"] == sum(p.numel() for p in
                                TM.param_specs(_reduced_port()).values())
    assert (tmp_path / "step_2").is_dir()
    again = train_lm.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                           "--seq-len", "16", "--ckpt-dir", str(tmp_path)])
    assert again["resumed"] and again["history"] == []
