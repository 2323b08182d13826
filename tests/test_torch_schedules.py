"""The port's tile table (``ops/schedules.py``) and the policy's tiles
against the reference's: the ``cpu`` section resolves as the reference's
``interpret`` section, ``with_tiles``/``tile_for``/hashing follow
``repro.ops.policy``, ``blocked`` attention takes the table's ``block_k``,
and a tile no Hopper kernel instance takes raises."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ops import policy as jpolicy
from repro.ops import registry as jregistry
from repro.ops import schedules as jsched
from repro_torch import ops
from repro_torch.launch import dryrun
from repro_torch.ops import policy as tpolicy
from repro_torch.ops import registry, schedules
from test_torch_threads import one_torch_thread  # noqa: F401

# float32 blocked attention, port against the reference: the same blocks
# and the same online-softmax order; the remaining gap is the two
# libraries' exp and dot roundings
ATTN_TOL = 2e-6

GRID = [dict(zip(("sq", "skv", "d"), v))
        for v in itertools.product((1, 64, 256, 1024, 4096),
                                   (1, 64, 255, 256, 1024, 2047, 2048, 8192),
                                   (64, 128))]


@pytest.mark.parametrize("dims", GRID, ids=lambda d: "-".join(
    f"{k}{v}" for k, v in d.items()))
def test_cpu_section_resolves_as_the_reference_interpret(dims):
    assert schedules.schedule_for("attention", "blocked", dims, "cpu") \
        == jsched.schedule_for("attention", "blocked", dims,
                               backend="interpret")
    # a card operand finds no cuda entry for the plain impl and takes the
    # cpu one, as the reference's tpu falls back to interpret
    assert schedules.schedule_for("attention", "blocked", dims, "cuda") \
        == schedules.schedule_for("attention", "blocked", dims, "cpu")


def test_cpu_entry_is_the_reference_interpret_entry():
    mine = schedules.table_entries()["cpu"]["attention.blocked"]
    ref = jsched.table_entries()["interpret"]["attention.blocked"]
    assert {k: v for k, v in mine.items() if k != "knobs"} == ref
    assert mine["knobs"] == ["block_k"]


def test_cuda_section_holds_only_kernel_knobs():
    # no Hopper kernel has a knob that some path selects: the GEMM
    # planners pick each launch's tile, the attention kernels have one
    assert schedules.table_entries()["cuda"] == {}
    for op in ("linear", "moe_grouped_gemm", "attention"):
        assert schedules.knobs(op, "cuda", "cuda") is None
    assert schedules.schedule_for("linear", "cuda",
                                  {"m": 1024, "n": 192, "k": 192},
                                  "cuda") == {}
    assert schedules.schedule_for("nothing", "cuda", {}, "cuda") == {}
    assert schedules.backend_key(torch.device("cpu")) == "cpu"
    assert schedules.backend_key("cuda") == "cuda"


OVERRIDES = [
    ("attention", {"block_k": 128}),
    ("attention", {"block_k": 64, "block_q": 32}),
    ("linear", {"tokens": 64, "warpgroups": 1}),
    ("moe_grouped_gemm", {"tokens": 16}),
]


@pytest.mark.parametrize("chain", range(len(OVERRIDES) + 1))
def test_with_tiles_matches_the_reference_policy(chain):
    mine, ref = tpolicy.ComputePolicy(), jpolicy.ComputePolicy()
    for op, blocks in OVERRIDES[:chain]:
        mine, ref = mine.with_tiles(op, **blocks), ref.with_tiles(op,
                                                                  **blocks)
    assert mine.tiles == ref.tiles
    for op in ("attention", "linear", "moe_grouped_gemm", "activation"):
        assert mine.tile_for(op) == ref.tile_for(op)
    # hashing: frozen, equal tiles hash equal, merged in the same order
    same = tpolicy.ComputePolicy(tiles=dict(
        (op, dict(b)) for op, b in mine.tiles))
    assert same == mine and hash(same) == hash(mine)
    assert tpolicy.ComputePolicy(tiles=ref.tiles) == mine
    if chain:
        assert mine != tpolicy.ComputePolicy()


def test_with_tiles_merges_later_blocks_over_earlier():
    p = ops.policy_named("cuda").with_tiles("linear", tokens=64)
    p = p.with_tiles("linear", warpgroups=2).with_tiles("linear", tokens=128)
    r = jpolicy.policy_named("pallas").with_tiles("linear", tokens=64)
    r = r.with_tiles("linear", warpgroups=2).with_tiles("linear", tokens=128)
    assert p.tile_for("linear") == r.tile_for("linear") \
        == {"tokens": 128, "warpgroups": 2}
    assert p.impls == ops.policy_named("cuda").impls


def _qkv(skv, seed=0):
    g = np.random.default_rng(seed)
    shape = (1, 2, skv, 64)
    return [g.standard_normal(shape, dtype=np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("skv", [256, 2048])
def test_blocked_attention_takes_the_table(skv, causal, monkeypatch):
    """The port's ``blocked`` at the table's block (128 from skv 256, 512
    from 2048) against the reference's ``blocked`` under its ``xla``
    policy family, float32."""
    q, k, v = _qkv(skv)
    with jpolicy.use_policy(jpolicy.policy_named("blocked")):
        want = np.asarray(jregistry.dispatch(
            "attention", jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            causal=causal))
    seen = []
    from repro_torch.core import attention as A

    blocked = A.blocked_attention

    def spy(*a, block_k, **kw):
        seen.append(block_k)
        return blocked(*a, block_k=block_k, **kw)

    monkeypatch.setattr(A, "blocked_attention", spy)
    with ops.use_policy(ops.policy_named("blocked")):
        got = ops.dispatch("attention", *map(torch.from_numpy, (q, k, v)),
                           causal=causal).numpy()
    assert seen == [128 if skv < 2048 else 512]
    np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=ATTN_TOL)


def test_policy_override_beats_the_table(monkeypatch):
    from repro_torch.core import attention as A

    seen = []
    blocked = A.blocked_attention
    monkeypatch.setattr(A, "blocked_attention", lambda *a, block_k, **kw: (
        seen.append(block_k), blocked(*a, block_k=block_k, **kw))[1])
    q, k, v = map(torch.from_numpy, _qkv(256))
    pol = ops.policy_named("blocked").with_tiles("attention", block_k=32)
    with ops.use_policy(pol):
        ops.dispatch("attention", q, k, v)
    assert seen == [32]


def test_unknown_block_raises():
    q, k, v = map(torch.from_numpy, _qkv(64))
    pol = ops.policy_named("blocked").with_tiles("attention", block_q=32)
    with ops.use_policy(pol), pytest.raises(ValueError, match="block_q"):
        ops.dispatch("attention", q, k, v)


def _gemm_operands(m=1024, k=192, n=768):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((m, k), generator=g).to(torch.bfloat16),
            torch.randn((k, n), generator=g).to(torch.bfloat16))


GEMM_TILES = [dict(tokens=48), dict(tokens=64, warpgroups=3),
              dict(warpgroups=2, tokens=8)]


@pytest.mark.parametrize("tile", GEMM_TILES)
def test_illegal_cuda_tile_raises_on_the_card(monkeypatch, tile):
    """The GEMM kernels take no tile from the table (its ``cuda`` section
    is empty: the planner picks each launch's tile), so any override of
    ``linear.cuda`` raises with the operands on the card (the device rule
    faked, as the hygiene tests do), never silently ignored; on the CPU
    the plain version ignores it, as the reference's plain impls do."""
    x, w = _gemm_operands()
    pol = ops.policy_named("cuda").with_tiles("linear", **tile)
    with ops.use_policy(ops.policy_named("cuda")):
        want = ops.dispatch("linear", x, w)
    with ops.use_policy(pol):
        assert torch.equal(ops.dispatch("linear", x, w), want)
        monkeypatch.setattr(registry, "_mode", lambda a: "cuda")
        with pytest.raises(ValueError, match="no tile override"):
            ops.dispatch("linear", x, w)


@pytest.mark.parametrize("tile", GEMM_TILES)
def test_moe_gemm_takes_no_override_on_the_card(monkeypatch, tile):
    g = torch.Generator().manual_seed(1)
    buf = torch.randn((2, 4, 8, 32), generator=g).to(torch.bfloat16)
    w = torch.randn((4, 32, 64), generator=g).to(torch.bfloat16)
    sizes = torch.full((2, 4), 8, dtype=torch.int32)
    pol = ops.policy_named("cuda").with_tiles("moe_grouped_gemm", **tile)
    monkeypatch.setattr(registry, "_mode", lambda a: "cuda")
    with ops.use_policy(pol), pytest.raises(ValueError,
                                            match="no tile override"):
        ops.dispatch("moe_grouped_gemm", buf, w, sizes)


def test_no_override_skips_the_tile_table(monkeypatch):
    """A dispatch with no override, to an impl that takes no tiles, never
    reads the table (the unmeshed serving paths pay nothing for it); an
    impl with ``dims`` still resolves its blocks."""
    from repro_torch.ops import schedules

    calls = []
    for fn in ("check_override", "schedule_for", "backend_key"):
        real = getattr(schedules, fn)
        monkeypatch.setattr(schedules, fn,
                            lambda *a, _f=real, _n=fn, **kw:
                            (calls.append(_n), _f(*a, **kw))[1])
    x, w = _gemm_operands(m=16)
    with ops.use_policy(ops.policy_named("cuda")):
        ops.dispatch("linear", x, w)
    assert calls == []
    q, k, v = map(torch.from_numpy, _qkv(64))
    with ops.use_policy(ops.policy_named("blocked")):
        ops.dispatch("attention", q, k, v)
    assert "schedule_for" in calls


def test_dryrun_attn_block_k_runs_one_cell(tmp_path, capsys):
    rc = dryrun.main(["--arch", "llama3_2_1b", "--shape", "decode_32k",
                      "--attn-block-k", "128", "--out", str(tmp_path)])
    assert rc == 0
    assert list(tmp_path.glob("*.json"))
