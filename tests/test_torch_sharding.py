"""The port's sharding rule table (``dist/sharding.py``) term for term
against the reference's (``repro.dist.sharding``): every parameter of every
smoke configuration and every logical activation name, trimmed on stub
meshes from 1×1 to 2×16×16, under each FSDP mode and with and without
sequence sharding.  The reference's table is pure spec logic: it reads only
``mesh.shape`` and ``mesh.axis_names``, so a stub object serves both."""

import functools
from types import SimpleNamespace

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import sharding as JS
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.dist import sharding as TS
from repro_torch.models import model as TM
from test_torch_threads import one_torch_thread  # noqa: F401

MESHES = {
    "1x1": {"data": 1, "model": 1},
    "1x2": {"data": 1, "model": 2},
    "2x2": {"data": 2, "model": 2},
    "1x4": {"data": 1, "model": 4},
    "2x4": {"data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
FSDP = [True, False, "moe_only"]
ARCHS = sorted(jconfigs.ARCH_NAMES)


def _stub(name):
    shape = MESHES[name]
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    """{path string: shape} of the reference's smoke parameters."""
    cfg = jconfigs.get(arch, smoke=True)
    tree = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 cfg))
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {JS._path_str(p): tuple(a.shape) for p, a in leaves}


def test_port_parameter_names_are_the_reference_paths():
    for arch in ARCHS:
        ref = _reference_params(arch)
        mine = TM.param_specs(tconfigs.get(arch, smoke=True))
        assert {TS._path_str(n): tuple(t.shape) for n, t in mine.items()} \
            == ref, arch


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("fsdp", FSDP, ids=str)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_parameter_specs_equal_the_reference(mesh, fsdp, seq_shard):
    stub = _stub(mesh)
    mine = TS.ShardingRules.for_mesh(stub, seq_shard=seq_shard, fsdp=fsdp)
    ref = JS.ShardingRules.for_mesh(stub, seq_shard=seq_shard, fsdp=fsdp)
    assert mine.batch_axes == ref.batch_axes
    assert mine.batch_entry == ref.batch_entry
    for arch in ARCHS:
        params = TM.param_specs(tconfigs.get(arch, smoke=True))
        table = TS.param_sharding_rules(params, mine)
        for name, t in params.items():
            path = TS._path_str(name)
            want = JS._match_param_spec(path, tuple(t.shape), ref)
            assert tuple(table[name].spec) == tuple(want), (arch, path)


# logical names against a spread of shapes: divisible and not by every
# stub mesh's axes (2, 4, 16, 32)
LOGICAL_SHAPES = {
    "btd": [(8, 128, 192), (1, 1, 64), (3, 64, 96), (64, 4096, 2048)],
    "btf": [(8, 128, 768), (2, 5, 48)],
    "btw": [(8, 128, 768), (2, 5, 48)],
    "btv": [(8, 1, 128256), (4, 7, 50)],
    "bhsd": [(8, 3, 128, 64), (2, 32, 64, 64), (1, 16, 1, 128)],
    "bkvsd": [(8, 8, 128, 64), (2, 2, 64, 64)],
    "cache": [(8, 8, 512, 64), (8, 2, 512, 64), (1, 1, 16, 64),
              (32, 16, 64, 128)],
    "ecd": [(16, 40, 192), (6, 8, 32), (256, 64, 7168)],
    "scd": [(16, 40, 192), (8, 8, 32)],
}


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("fsdp", FSDP, ids=str)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_specs_equal_the_reference(mesh, fsdp, seq_shard):
    stub = _stub(mesh)
    mine = TS.ShardingRules.for_mesh(stub, seq_shard=seq_shard, fsdp=fsdp)
    ref = JS.ShardingRules.for_mesh(stub, seq_shard=seq_shard, fsdp=fsdp)
    assert set(mine.logical) == set(ref.logical) == set(LOGICAL_SHAPES)
    for name, shapes in LOGICAL_SHAPES.items():
        for shape in shapes:
            got = TS._pick_spec(shape, mine.logical[name], stub)
            want = JS._pick_spec(shape, ref.logical[name], stub)
            assert tuple(got) == tuple(want), (name, shape)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_trim_and_pad_equal_the_reference(mesh):
    stub = _stub(mesh)
    specs = [(), ("data",), ("model", None), (("pod", "data"), "model"),
             (None, ("data", "model"), None), ("model", "data", None, None)]
    shapes = [(8,), (6, 4), (32, 64, 3), (2, 16, 16, 5), (1,)]
    for spec in specs:
        for shape in shapes:
            for left in (False, True):
                got = TS._trim_spec(shape, TS.P(*spec), stub, pad_left=left)
                want = JS._trim_spec(shape, JS.P(*spec), stub,
                                     pad_left=left)
                assert tuple(got) == tuple(want), (spec, shape, left)
                assert tuple(TS._rank_pad(shape, TS.P(*spec), left)) \
                    == tuple(JS._rank_pad(shape, JS.P(*spec), left))


def test_batch_and_opt_state_tables_follow_the_reference():
    from repro_torch.optim.adamw import OptConfig, adamw_init

    stub = _stub("2x4")
    mine = TS.ShardingRules.for_mesh(stub)
    cfg = tconfigs.get("llama4_scout_17b_a16e", smoke=True)
    params = TM.param_specs(cfg)
    batch = TS.batch_sharding({"tokens": torch.empty((8, 16)),
                               "step": torch.empty(()),
                               "odd": torch.empty((3, 4))}, mine)
    assert tuple(batch["tokens"].spec) == ("data", None)
    assert tuple(batch["step"].spec) == ()
    assert tuple(batch["odd"].spec) == (None, None)
    state = adamw_init(params, OptConfig(factored=True))
    table = TS.opt_state_shardings(state, params, mine)
    ptable = TS.param_sharding_rules(params, mine)
    for name, st in table["ema"].items():
        spec = tuple(ptable[name].spec)
        assert tuple(st["m"].spec) == spec
        if "vr" in st:
            assert tuple(st["vr"].spec) == spec[:-1]
            assert tuple(st["vc"].spec) == spec[:-2] + spec[-1:]
    assert tuple(table["step"].spec) == ()


def test_ep_dispatch_sharding_spec():
    stub = _stub("2x16x16")
    assert tuple(TS.ep_dispatch_sharding(stub).spec) == ("model", None,
                                                         None)


def test_constrain_is_free_outside_rules_and_for_local_shards():
    x = torch.ones(2, 3, 4)
    assert TS.constrain(x, "btd") is x
    with TS.use_rules(TS.ShardingRules.for_mesh(_stub("2x4"))):
        assert TS.constrain(x, "btd") is x        # a local shard
        assert TS.constrain(x, "no_such_rule") is x
        assert TS.current_rules() is not None
    assert TS.current_rules() is None
