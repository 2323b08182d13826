"""The port's configuration tables and M-RoPE against the JAX reference.

* Every configuration of the reference (``ARCH_NAMES`` and
  ``m3vit_many``), its ``CONFIG`` and its ``SMOKE_CONFIG``, equals the
  reference's field for field (the ``MoESpec`` too); ``m3vit_many``'s
  module constants as well.
* ``param_count`` and ``active_param_count``: exactly equal for every
  config (pure arithmetic, copied term for term).
* ``SHAPES``, ``ARCH_NAMES``, ``list_archs()``, ``cells(False)`` and
  ``cells(True)``: equal.
* ``apply_mrope`` against ``repro.models.layers.apply_mrope`` in float32,
  with three distinct position streams and with a (B, S) position
  broadcast to all three as the attention layer does: max abs difference
  <= 1e-6 (float32 rotations of the same angles).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from test_torch_threads import one_torch_thread  # noqa: F401

ALL = tuple(jconfigs.ARCH_NAMES) + ("m3vit_many",)
MROPE_TOL = 1e-6


def _fields(cfg) -> dict:
    """A config as a dict of its fields, nested dataclasses included."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", ALL)
def test_config_equals_reference(arch, smoke):
    got, want = tconfigs.get(arch, smoke=smoke), jconfigs.get(arch,
                                                              smoke=smoke)
    assert _fields(got) == _fields(want)
    assert (got.hd, got.period) == (want.hd, want.period)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_m3vit_many_constants():
    got = importlib.import_module("repro_torch.configs.m3vit_many")
    want = importlib.import_module("repro.configs.m3vit_many")
    assert (got.NUM_EXPERTS, got.NUM_TASKS, got.TASKS) == \
        (want.NUM_EXPERTS, want.NUM_TASKS, want.TASKS) == \
        (256, 8, tuple(f"tenant{i}" for i in range(8)))
    assert got.SMOKE_CONFIG.moe.num_experts == 256
    assert got.SMOKE_CONFIG.moe.d_ff == 256


def test_tables_equal_reference():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.list_archs() is not tconfigs.ARCH_NAMES
    assert {k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    assert {k: v.tokens for k, v in tconfigs.SHAPES.items()} == \
        {k: v.tokens for k, v in jconfigs.SHAPES.items()}
    from repro.configs.base import cells as jcells

    for skipped in (False, True):
        assert tconfigs.cells(skipped) == jcells(skipped)
    assert len(tconfigs.cells(True)) == 4 * (len(ALL) - 2)
    assert tconfigs.__all__ == jconfigs.__all__


def test_get_resolves_names_and_refuses_unknown():
    assert tconfigs.get("qwen2-vl-72b").name == "qwen2_vl_72b"
    assert tconfigs.get("qwen1.5_4b").name == "qwen1_5_4b"
    with pytest.raises(ValueError, match="unknown config"):
        tconfigs.get("no_such_arch")


def _positions(b, s, distinct: bool) -> np.ndarray:
    rng = np.random.default_rng(7)
    if distinct:
        return rng.integers(0, 4096, (3, b, s)).astype(np.int32)
    return rng.integers(0, 4096, (b, s)).astype(np.int32)


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("distinct", [True, False],
                         ids=["three_streams", "broadcast"])
def test_apply_mrope_matches_reference(hd, distinct):
    b, h, s = 2, 3, 11
    x = np.random.default_rng(hd).standard_normal(
        (b, h, s, hd)).astype(np.float32)
    pos = _positions(b, s, distinct)
    pos3 = pos if distinct else np.broadcast_to(pos, (3, b, s))
    want = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                     1e6))
    tpos = torch.from_numpy(np.ascontiguousarray(pos))
    tpos3 = tpos if distinct else tpos.expand(3, b, s)
    got = TL.apply_mrope(torch.from_numpy(x), tpos3, 1e6).numpy()
    assert np.abs(got - want).max() <= MROPE_TOL
    if distinct:      # the sections really take their own streams
        one = TL.apply_mrope(torch.from_numpy(x), tpos[0].expand(3, b, s),
                             1e6).numpy()
        assert np.abs(one - got).max() > 1e-3
    half = hd // 2
    assert (int(half * 0.25), int(half * 0.375)) == \
        (int(half * TL.MROPE_SECTIONS[0]), int(half * TL.MROPE_SECTIONS[1]))
