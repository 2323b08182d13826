"""FSDP of serving's weights on the CPU: ``serve.engine.place_params``
holds every leaf at its block of the reference's table over the data axes
and ``model`` under FSDP rules (``fsdp=True`` or ``"moe_only"``), and the
forward gathers each layer's leaves just before the layer runs
(``serve.engine.fsdp_gathers``, ``models.transformer.forward(gather=)``).

In process, on a device-free mesh and ``meta`` tensors at full size, at
2×1, 2×2, 4×1 and 16×16: a rank's held shape of every leaf of
Llama-3.2-1B, DeepSeek-67B, RecurrentGemma-9B, xLSTM-350M and
Llama-4-Scout (``grouped`` and ``ep_local``) equals the block of the
reference's trimmed spec over ``data`` and ``model``
(``repro.dist.sharding._match_param_spec`` on a stub mesh); the shapes
the forward computes at after its gathers, and the decode state's
blocks, equal ``local_params``' under ``fsdp=False``; under ``False``
``place_params`` returns ``local_params``' tensors.

Spawned gloo worlds at (2, 1) and (2, 2), one process a rank
(``tests/_torch_tp_worker.py``): at the smoke configs of Llama-3.2-1B,
Kimi-K2, RecurrentGemma-9B and xLSTM-350M, the engine's prefill logits
and greedy tokens and a scheduler's tokens under FSDP rules bit for bit
against the same mesh under ``fsdp=False`` (Kimi-K2 under ``"moe_only"``
too), the ``"fsdp gather"`` all-gathers as counted from the config and
nothing else new, a rank's held bytes the table's blocks, the per-rank
draw; and float32 greedy tokens under FSDP equal to the reference's
unmeshed ``repro.serve.engine.ServingEngine`` on the same weights.

The reference's own mesh serving tests fail on this jax (0.9.0: meshes
come with Explicit axes; ``ROADMAP.md`` queue 3), so the port is held
against the reference's table and its unmeshed engine, not its meshed
one."""

import functools
import os
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_tp_worker as W
from repro import configs as jconfigs
from repro.dist import sharding as JS
from repro.models import model as jmodel
from repro.ops import policy_named as jpolicy_named
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.dist.sharding import ShardingRules, _path_str
from repro_torch.dist.spmd import VirtualMesh
from repro_torch.models import model as TM
from repro_torch.models import transformer as T
from repro_torch.serve.engine import (fsdp_gathers, local_params,
                                      place_params)
from test_torch_threads import one_torch_thread  # noqa: F401

MESHES = {"2x1": (2, 1), "2x2": (2, 2), "4x1": (4, 1), "16x16": (16, 16)}
ARCHS = ("llama3_2_1b", "deepseek_67b", "recurrentgemma_9b", "xlstm_350m",
         "llama4_scout_17b_a16e")
FSDP = {"true": True, "moe_only": "moe_only", "false": False}


@functools.lru_cache(maxsize=None)
def _shapes(arch, ep_local=False):
    cfg = tconfigs.get(arch)
    if ep_local:
        cfg = replace(cfg, moe=replace(cfg.moe, impl="ep_local"))
    return cfg, TM.param_specs(cfg)


def _reference_block(path, shape, ref_rules, sizes):
    """The block of the reference's trimmed spec over every mesh axis."""
    spec = JS._match_param_spec(path, shape, ref_rules)
    out = []
    for d, e in zip(shape, spec):
        for a in () if e is None else (e,) if isinstance(e, str) else e:
            d //= sizes[a]
        out.append(d)
    return tuple(out)


@pytest.mark.parametrize("fsdp", list(FSDP))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,ep_local", [(a, False) for a in ARCHS]
                         + [("llama4_scout_17b_a16e", True)],
                         ids=list(ARCHS) + ["llama4_scout_ep_local"])
def test_place_params_holds_the_reference_spec_blocks(arch, ep_local, mesh,
                                                      fsdp):
    cfg, shapes = _shapes(arch, ep_local)
    vmesh = VirtualMesh(MESHES[mesh], ("data", "model"))
    stub = SimpleNamespace(shape=dict(zip(("data", "model"), MESHES[mesh])),
                           axis_names=("data", "model"))
    rules = ShardingRules.for_mesh(vmesh, fsdp=FSDP[fsdp])
    off = ShardingRules.for_mesh(vmesh, fsdp=False)
    held = place_params(shapes, cfg, rules)
    local = local_params(shapes, cfg, off)
    gathers = fsdp_gathers(held, cfg, rules)
    if FSDP[fsdp] is False:
        assert gathers is None
        assert all(held[k].shape == local[k].shape for k in shapes)
        return
    ref_rules = JS.ShardingRules.for_mesh(stub, fsdp=FSDP[fsdp])
    for name, t in shapes.items():
        path = _path_str(name)
        got = tuple(held[name].shape)
        assert got == _reference_block(path, tuple(t.shape), ref_rules,
                                       stub.shape), (arch, path, got)
        # the forward computes on what fsdp=False holds
        assert T.computed_shape(name, held[name], gathers) \
            == tuple(local[name].shape), (arch, path)
    assert T.state_blocks(held, cfg, gathers) == T.state_blocks(local, cfg)
    # blocks as held are kept as they are
    again = place_params(held, cfg, rules)
    assert all(again[k] is held[k] for k in held)


def test_place_params_raises_on_a_foreign_block():
    """A leaf at ``fsdp=False``'s block over ``model`` alone is neither
    whole nor this rank's FSDP block: it raises, never held whole."""
    cfg, shapes = _shapes("llama3_2_1b")
    vmesh = VirtualMesh((2, 2), ("data", "model"))
    local = local_params(shapes, cfg, ShardingRules.for_mesh(
        vmesh, fsdp=False))
    with pytest.raises(ValueError, match="neither the whole leaf"):
        place_params(local, cfg, ShardingRules.for_mesh(vmesh))


def test_gathers_skip_packed_groups_and_axes_of_one_rank():
    """No gather on a mesh of one rank an axis (``fsdp_gathers`` is None);
    a packed (QTensor) group stays whole and is never gathered."""
    from repro_torch.quant import quantize

    cfg, shapes = _shapes("llama3_2_1b")
    one = ShardingRules.for_mesh(VirtualMesh((1, 1), ("data", "model")))
    assert fsdp_gathers(place_params(shapes, cfg, one), cfg, one) is None
    small = tconfigs.get("llama3_2_1b", smoke=True)
    params = TM.init_params(0, small, device="cpu")
    params["layers.b0.mlp.wg"] = quantize(params["layers.b0.mlp.wg"], 8)
    rules = ShardingRules.for_mesh(VirtualMesh((2, 1), ("data", "model")))
    held = place_params(params, small, rules)
    gathers = fsdp_gathers(held, small, rules)
    for k in ("layers.b0.mlp.wg", "layers.b0.mlp.wu", "layers.b0.mlp.wd"):
        assert held[k] is params[k] and k not in gathers.params, k
    assert held["layers.b0.attn.wq"].shape[-2] * 2 == small.d_model


def _reference_tokens(path, arch):
    """The reference's float32 smoke ``arch`` with no mesh: its weights
    (carried into the port by the bridge), 4 prompts of 8 tokens and
    ``W.FSDP_NEW`` greedy tokens of its ``ServingEngine`` under exact
    activations (``xla``), written to ``path`` for
    ``_torch_tp_worker.check_fsdp_reference``."""
    jcfg = replace(jconfigs.get(arch, smoke=True), dtype="float32")
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(3),
                                                jcfg))
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (4, 8)).astype(np.int32)
    tokens = JServingEngine(jcfg, jparams, JServeConfig(
        max_len=32, policy=jpolicy_named("xla"))).generate(
            jnp.asarray(prompts), W.FSDP_NEW)
    out = {f"param:{k}": v.numpy()
           for k, v in params_from_jax(jparams, device="cpu").items()}
    np.savez(path, prompts=prompts, tokens=np.asarray(tokens), **out)


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """The reference's runs of :func:`_reference_tokens`, once for both
    worlds."""
    path = tmp_path_factory.mktemp("fsdp_ref")
    for arch in W.FSDP_ARCHS:
        _reference_tokens(os.path.join(path, f"fsdp_ref_{arch}.npz"), arch)
    return path


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fsdp_serving_world(shape, reference_dir, tmp_path):
    """``_torch_tp_worker.check_fsdp`` on every rank of the world, then
    ``check_fsdp_reference`` against the reference's unmeshed engine."""
    world = shape[0] * shape[1]
    ref = functools.partial(W.check_fsdp_reference, workdir=reference_dir)
    mp.start_processes(W.run, args=(world, shape,
                                    os.path.join(tmp_path, "store"),
                                    [W.check_fsdp, ref]),
                       nprocs=world, start_method="spawn")


def test_gather_counts_of_the_smoke_llama():
    """``fsdp_gather_counts`` by hand for the tied smoke Llama at 2×1:
    each layer's seven matrices over data, the table twice (lookup and
    head), a forward; at 2×2 the same over data (each split over model is
    computed on its block there), none over model."""
    cfg = tconfigs.get("llama3_2_1b", smoke=True)
    for shape in ((2, 1), (2, 2)):
        rules = ShardingRules.for_mesh(VirtualMesh(shape, ("data",
                                                           "model")))
        assert W.fsdp_gather_counts(cfg, rules, 3) == {
            "data": 3 * (7 * cfg.num_layers + 2)}, shape
