"""The port's M³ViT forward against the JAX reference, on the CPU.

The JAX ``repro.models.vit.forward`` runs under ``policy_named("pallas")``
(the Pallas kernels in interpret mode, as the JAX tests run them on the
CPU); the port's ``forward`` runs under ``policy_named("cuda")`` with CPU
tensors (each kernel module's plain version), on weights carried over by
``bridge.params_from_jax``.  Both tasks, on ``SMOKE_CONFIG`` and at full
width with 2 layers (one dense, one MoE block).

Tolerances: bf16 — cosine >= 0.999 per task (a near-tie in a bf16 gate
logit can flip one token's expert).  float32 — max |diff| <= 1e-4 × the
output's max magnitude with exact activations on both sides.  With the LUT
activations of the two policies, a float32 pre-activation that lies on a
table-index half-step can round to the neighbouring entry under another
summation order, and a flipped entry moves the output by far more than
float32 rounding does.  There the bound is LUT_BOUND × the output's max
magnitude, fixed from these readings of max |diff| / max |output| (CPU,
seed 0, two images; ``python tests/test_torch_m3vit.py`` prints them):

    config               task    port vs JAX pallas   JAX blocked vs pallas
    smoke                semseg  2.012e-04            1.196e-04
    smoke                depth   1.232e-04            8.657e-05
    full width, 2 layers semseg  5.269e-05            6.131e-05
    full width, 2 layers depth   4.789e-05            5.139e-05

LUT_BOUND is 2.5× the largest port reading, so another machine's float32
summation order (and its own index flips) stays inside it; the exact
comparison of the same weights holds 1e-4 (readings <= 8e-7), so nothing
but the flips is allowed the wider bound.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.checkpoint import checkpoint as jckpt
from repro.configs import m3vit as JM
from repro.models import vit as jvit
from repro_torch import ops
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import m3vit as TM
from repro_torch.kernels.compare import cosine
from repro_torch.models import vit
from repro_torch.serve.vision import M3ViTServer

CONFIGS = {
    "smoke": (JM.SMOKE_CONFIG, TM.SMOKE_CONFIG),
    "full_width_2_layers": (replace(JM.CONFIG, num_layers=2),
                            replace(TM.CONFIG, num_layers=2)),
}
LUT_BOUND = 5e-4
EXACT = {"jax": jops.policy_named("pallas").with_impls(activation="xla"),
         "port": ops.policy_named("cuda").with_impls(activation="eager")}


def _images(b=2, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, TM.IMAGE_H, TM.IMAGE_W, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _models(name, dtype):
    jc, tc = CONFIGS[name]
    jcfg, tcfg = replace(jc, dtype=dtype), replace(tc, dtype=dtype)
    jparams = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams, dtype


@pytest.fixture(params=[(c, d) for c in CONFIGS
                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def models(request):
    return _models(*request.param)


def _jax_forward(jparams, img, jcfg, task, policy):
    with jops.use_policy(policy):
        y, aux = jvit.forward(jparams, jnp.asarray(img), jcfg, task=task)
    return np.array(y), float(aux)


def _port_forward(tparams, img, tcfg, task, policy):
    with ops.use_policy(policy):
        y, aux = vit.forward(tparams, torch.from_numpy(img), tcfg, task=task)
    return y.numpy(), float(aux)


@pytest.mark.parametrize("task", TM.TASKS)
def test_forward_matches_jax_pallas(models, task):
    jcfg, tcfg, jparams, tparams, dtype = models
    img = _images()
    want, jaux = _jax_forward(jparams, img, jcfg, task,
                              jops.policy_named("pallas"))
    got, taux = _port_forward(tparams, img, tcfg, task,
                              ops.policy_named("cuda"))
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    if dtype == "bfloat16":
        assert cosine(torch.from_numpy(got), torch.from_numpy(want)) >= 0.999
        return
    assert np.abs(got - want).max() <= LUT_BOUND * np.abs(want).max()
    assert abs(taux - jaux) <= 1e-4 * abs(jaux)


@pytest.mark.parametrize("task", TM.TASKS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_forward_matches_jax_exact_activations_fp32(config, task):
    jcfg, tcfg, jparams, tparams, _ = _models(config, "float32")
    img = _images()
    want, _ = _jax_forward(jparams, img, jcfg, task, EXACT["jax"])
    got, _ = _port_forward(tparams, img, tcfg, task, EXACT["port"])
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.fixture(scope="module")
def smoke_port():
    cfg = replace(TM.SMOKE_CONFIG, policy=ops.policy_named("cuda"))
    return cfg, vit.init_params(3, cfg, device="cpu")


@pytest.mark.parametrize("task", TM.TASKS)
def test_server_infer_equals_forward(smoke_port, task):
    cfg, params = smoke_port
    img = _images(b=3, seed=4)
    server = M3ViTServer(cfg, params, device="cpu")
    got = server.infer(img, task)
    want, _ = vit.forward(params, torch.from_numpy(img), cfg, task=task)
    np.testing.assert_array_equal(got, want.numpy())
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(server.infer(img, TM.TASKS.index(task)),
                                  got)


def test_module_matches_functional_forward(smoke_port):
    cfg, params = smoke_port
    model = vit.M3ViT(cfg, params, device="cpu")
    assert list(model.state_dict()) == list(params)
    img = torch.from_numpy(_images(b=1))
    y_mod, _ = model(img, task="depth")
    y_fn, _ = vit.forward(params, img, cfg, task="depth")
    torch.testing.assert_close(y_mod, y_fn, rtol=0, atol=0)


def test_dispatch_report_hits_the_kernel_impls(smoke_port):
    cfg, params = smoke_port
    ops.reset_dispatch_report()
    vit.forward(params, torch.from_numpy(_images(b=1)), cfg, task="semseg")
    report = ops.dispatch_report()
    n_layers = cfg.num_layers
    n_moe = n_layers // 2
    expected = {"linear": 4 * n_layers + 2 * (n_layers - n_moe) + 2,
                "attention": n_layers, "moe_grouped_gemm": 2 * n_moe,
                "activation": n_moe}
    for op, n in expected.items():
        entry = report[op]
        assert entry["hits"] == {"cuda": n}, (op, entry)
        assert entry["fallbacks"] == []
        assert entry["modes"] == {"cuda": {"cpu": n}}
    (fb,) = report["moe_ffn"]["fallbacks"]
    assert report["moe_ffn"]["hits"] == {}
    assert fb["requested"] == "cuda" and fb["used"] == "eager"
    assert fb["count"] == n_moe
    assert fb["reasons"] == ["cuda: not a registered impl for 'moe_ffn' "
                             "(registered: ['cuda_fused', 'eager', 'ref'])"]


def test_bridge_bf16_round_trip():
    """bf16 leaves keep their bits: JAX tree -> port -> NumPy bits."""
    cfg = JM.SMOKE_CONFIG
    jparams = jax.device_get(jvit.init_params(jax.random.PRNGKey(5), cfg))
    port = params_from_jax(jparams, device="cpu")
    flat = {jckpt._path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert set(port) == set(flat)
    assert port["layers.b1.moe.w1"].dtype == torch.bfloat16
    assert port["layers.b1.moe.w1"].shape == flat["layers.b1.moe.w1"].shape
    assert port["layers.b1.moe.b1"].dtype == torch.float32
    for name, leaf in flat.items():
        t = port[name]
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                np.asarray(leaf).view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
        back = tensor_from_numpy(np.asarray(leaf))
        assert back.dtype == t.dtype and torch.equal(back, t)


def test_bridge_reads_a_checkpoint_directory(tmp_path):
    cfg = JM.SMOKE_CONFIG
    jparams = jvit.init_params(jax.random.PRNGKey(6), cfg)
    path = jckpt.save(str(tmp_path), 7, jparams)
    from_dir = params_from_jax(path, device="cpu")
    from_tree = params_from_jax(jax.device_get(jparams), device="cpu")
    assert set(from_dir) == set(from_tree)
    for name, t in from_tree.items():
        assert from_dir[name].dtype == t.dtype
        assert torch.equal(from_dir[name], t)


def parity_readings():
    """Yield (config, task, port LUT, JAX blocked vs pallas, port exact):
    max |diff| / max |JAX pallas output| at float32, the readings
    ``LUT_BOUND`` was fixed from."""
    for name in CONFIGS:
        jcfg, tcfg, jparams, tparams, _ = _models(name, "float32")
        img = _images()
        for task in TM.TASKS:
            want, _ = _jax_forward(jparams, img, jcfg, task,
                                   jops.policy_named("pallas"))
            blocked, _ = _jax_forward(jparams, img, jcfg, task,
                                      jops.policy_named("blocked"))
            got, _ = _port_forward(tparams, img, tcfg, task,
                                   ops.policy_named("cuda"))
            ex_want, _ = _jax_forward(jparams, img, jcfg, task, EXACT["jax"])
            ex_got, _ = _port_forward(tparams, img, tcfg, task,
                                      EXACT["port"])
            scale = np.abs(want).max()
            yield (name, task, np.abs(got - want).max() / scale,
                   np.abs(blocked - want).max() / scale,
                   np.abs(ex_got - ex_want).max() / np.abs(ex_want).max())


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_m3vit.py
    for row in parity_readings():
        print("%-20s %-7s port LUT %.3e  JAX blocked vs pallas %.3e  "
              "port exact %.3e" % row)
