"""The port's roofline (``repro_torch.roofline``) against the reference's.

* ``model_flops``: exactly the reference's for every
  ``configs.cells(include_skipped=True)`` cell (pure arithmetic).
* ``moe_traffic``'s three functions: exactly the reference's over a grid
  of sizes, kinds (gelu, swiglu) and dtypes (bf16, f32).
* The counter (``roofline/op_cost.py``) on its own: one matmul counts
  2·M·N·K; a loop of ten counts ten times one; an in-place update counts
  its update only; a slice counts nothing; the peak of live bytes follows
  allocations and frees; a kernel impl's plain version counts only its
  outputs' bytes as live; the smoke forwards count the same totals under
  ``eager``, ``blocked`` and ``cuda`` on the CPU; a loop shortened on
  ``meta`` (``op_cost.repeat``) counts the FLOPs of the whole loop, its
  backward too.
* Against the reference's ``analyze_hlo_text`` of
  ``jax.jit(f).lower(...).compile().as_text()`` on the CPU, for the
  forward of the smoke configs of M³ViT, Llama-3.2-1B, Llama-4-Scout and
  xLSTM-350M at 1024 tokens, both under the plain policies (``xla`` /
  ``eager``): the total FLOPs within 5 %, and the FLOPs of every named
  scope that holds at least 2 % of the reference's total within 5 %.
  Smaller scopes and ``other`` are printed, not held: XLA's fusions
  carry an op's scope from their root op, so elementwise work moves
  between scopes (and ops whose metadata the compiler drops land in
  ``other``; at 64 tokens Llama-4-Scout's one-hot dispatch and combine
  products do).  1024 tokens is a whole number of the port's 1024-row
  gating products (``core/moe.py:GATE_ROWS``): at fewer tokens its
  zero-padded gating rows add work the reference does not do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.models import model as JM
from repro.models import vit as JV
from repro.ops.policy import policy_named as jpolicy_named
from repro.ops.policy import use_policy as juse_policy
from repro.roofline import analysis as JA
from repro.roofline import moe_traffic as JT
from repro.roofline.hlo_cost import analyze_hlo_text
from repro_torch import configs as tconfigs
from repro_torch import ops
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.models import model as TM
from repro_torch.models import vit as TV
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import moe_traffic as TT
from repro_torch.roofline import op_cost
from repro_torch.roofline.op_cost import CostCounter, count_cost
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 0.05          # relative, per scope and in total
SCOPE_SHARE = 0.02  # scopes held to TOL: at least this share of the total


# ------------------------------------------------------------ arithmetic


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a, s, _ in jconfigs.cells(include_skipped=True)])
def test_model_flops_equal_the_reference(arch, shape):
    want = JA.model_flops(jconfigs.get(arch), JSHAPES[shape])
    assert TA.model_flops(tconfigs.get(arch), TSHAPES[shape]) == want


_GRID = [dict(tokens=t, d_model=d, d_ff=f, num_experts=e, capacity=c)
         for t, d, f, e, c in [(128, 192, 768, 16, 68),
                               (1024, 64, 128, 8, 260),
                               (4096, 5120, 8192, 16, 320), (7, 3, 5, 2, 4)]]


@pytest.mark.parametrize("kind", ["gelu", "swiglu"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("sizes", _GRID, ids=lambda s: str(s["tokens"]))
def test_moe_traffic_equal_the_reference(kind, dtype, sizes):
    kw = dict(sizes, kind=kind, param_dtype=dtype, act_dtype=dtype)
    assert TT.staged_moe_bytes(**kw) == JT.staged_moe_bytes(**kw)
    for active in (None, 3):
        assert TT.fused_moe_bytes(active_experts=active, **kw) \
            == JT.fused_moe_bytes(active_experts=active, **kw)
        assert TT.moe_traffic_report(active_experts=active, **kw) \
            == JT.moe_traffic_report(active_experts=active, **kw)
    # torch dtypes read as their names do
    tkw = dict(kw, param_dtype=getattr(torch, dtype),
               act_dtype=getattr(torch, dtype))
    assert TT.staged_moe_bytes(**tkw) == JT.staged_moe_bytes(**kw)


# ---------------------------------------------------------- the counter


def _rand(*shape, seed=0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32))


def test_one_matmul_counts_2mnk():
    a, b = _rand(128, 256), _rand(256, 512, seed=1)
    _, c = count_cost(torch.matmul, a, b)
    assert c.flops == 2 * 128 * 256 * 512
    assert c.bytes_accessed == 4 * (128 * 256 + 256 * 512 + 128 * 512)
    assert c.by_scope["other"]["flops"] == c.flops


def test_ten_matmuls_count_ten_times_one():
    x, w = _rand(64, 64), _rand(64, 64, seed=1)

    def loop():
        y = x
        for _ in range(10):
            y = torch.tanh(y @ w)
        return y

    _, one = count_cost(lambda: torch.tanh(x @ w))
    _, ten = count_cost(loop)
    assert one.flops == 2 * 64 ** 3 + 64 * 64
    assert one.transcendentals == 64 * 64
    assert ten.flops == 10 * one.flops
    assert ten.bytes_accessed == 10 * one.bytes_accessed


def test_in_place_update_counts_the_update_only():
    cache = torch.zeros(8, 4, 512, 64)
    new = _rand(8, 4, 1, 64)
    _, c = count_cost(lambda: cache[:, :, 7:8].copy_(new))
    assert c.flops == 0
    assert c.bytes_accessed == 2 * new.numel() * 4     # read + write region
    idx, rows = torch.tensor([3, 5]), _rand(2, 4, 512, 64)
    _, c = count_cost(lambda: cache.index_put_((idx,), rows))
    assert c.flops == 0
    assert c.bytes_accessed == 2 * rows.numel() * 4 + idx.numel() * 8


def test_slice_and_view_count_nothing():
    x = _rand(64, 128)
    _, c = count_cost(lambda: x[10:20].reshape(-1).view(20, 64)[:, 3:9])
    assert c.flops == 0 and c.bytes_accessed == 0
    assert c.peak_live_bytes == 0


def test_peak_live_bytes_follow_allocations_and_frees():
    def run():
        a = torch.ones(1000)            # 4000 B live
        b = torch.ones(500)             # 6000
        del a                           # 2000
        c = torch.ones(2000)            # 10000
        return b, c

    out, c = count_cost(run)
    assert c.peak_live_bytes == 10000
    del out


def test_kernel_impl_counts_its_outputs_only():
    """Under ``cuda`` on the CPU the flash wrapper runs its plain version,
    which materializes the scores; on the card the kernel keeps them on
    chip, so only the (B, H, S, D) output counts as live."""
    from repro_torch.core.attention import attention

    q, k, v = (_rand(2, 4, 256, 16, seed=i) for i in range(3))
    with ops.use_policy(ops.policy_named("cuda")):
        _, kern = count_cost(lambda: attention(q, k, v, causal=True))
    with ops.use_policy(ops.policy_named("eager")):
        _, plain = count_cost(lambda: attention(q, k, v, causal=True))
    assert kern.peak_live_bytes == q.numel() * 4
    assert plain.peak_live_bytes > 2 * 4 * 256 * 256 * 4
    assert kern.flops == plain.flops and kern.by_scope == plain.by_scope


def _m3vit_forward(policy, b=2):
    cfg = dataclasses.replace(tconfigs.get("m3vit", smoke=True),
                              policy=ops.policy_named(policy))
    params = TV.init_params(0, cfg, device="cpu")
    x = _rand(b, 128, 256, 3)
    return lambda: TV.forward(params, x, cfg, "semseg")


def _lm_forward(arch, policy, b=2, s=32):
    cfg = dataclasses.replace(tconfigs.get(arch, smoke=True),
                              policy=ops.policy_named(policy))
    params = TM.init_params(0, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)))
    return lambda: TM.forward(params, tokens, cfg)


@pytest.mark.parametrize("unit", ["m3vit", "llama3_2_1b",
                                  "llama4_scout_17b_a16e"])
def test_totals_equal_under_every_impl(unit):
    costs = {}
    for policy in ("eager", "blocked", "cuda", "cuda_fused"):
        fn = _m3vit_forward(policy) if unit == "m3vit" \
            else _lm_forward(unit, policy)
        with torch.no_grad():
            _, costs[policy] = count_cost(fn)
    base = costs["eager"]
    for policy, c in costs.items():
        assert c.flops == base.flops, policy
        assert c.bytes_accessed == base.bytes_accessed, policy
        assert c.by_scope == base.by_scope, policy


def test_shortened_loops_count_the_whole_loop():
    """xLSTM-350M's smoke train step (an sLSTM time loop, an mLSTM chunk
    loop, two microbatches) on ``meta``, where each loop runs one step
    scaled by its length, counts the FLOPs of the same step run whole on
    the CPU: forward, backward and optimizer."""
    from repro_torch.launch import dryrun
    from repro_torch.configs.base import Shape

    shape = Shape("tiny", "train", 32, 4)
    counts = {}
    for device in ("cpu", "meta"):
        fn, args, cfg, _ = dryrun.build_cell(
            "xlstm_350m", "", {"accum": 2}, smoke=True, shape=shape,
            device=device)
        if device == "cpu":
            params, opt, specs = args
            for k, v in params.items():
                v.copy_(_rand(*v.shape, seed=len(k)).to(v.dtype) * 0.1)
            specs["inputs"].copy_(torch.randint(0, cfg.vocab_size,
                                                specs["inputs"].shape))
            specs["labels"].copy_(specs["inputs"])
        with ops.use_policy(ops.policy_named("cuda")):
            _, counts[device] = count_cost(fn, *args)
    cpu, meta = counts["cpu"], counts["meta"]
    # the forward, scope by scope, exactly
    for name in ("mlstm", "slstm", "norm", "lm_head", "loss", "adamw"):
        assert meta.by_scope[name]["flops"] == cpu.by_scope[name]["flops"]
    # the backward (counted as "other") within 1 %: autograd's bookkeeping
    # of n steps is not n times one step's — step 0 reads a state that
    # needs no gradient, and the sums of the per-step gradients of the
    # inputs every step reads are modeled (repeat.begin's ``each``)
    assert abs(meta.flops - cpu.flops) <= 0.01 * cpu.flops
    prefill = Shape("tiny", "prefill", 32, 4)
    fwd = {}
    for device in ("cpu", "meta"):
        fn, args, cfg, _ = dryrun.build_cell(
            "xlstm_350m", "", smoke=True, shape=prefill, device=device)
        if device == "cpu":
            args[0].update({k: _rand(*v.shape, seed=len(k)).to(v.dtype)
                            * 0.1 for k, v in args[0].items()})
            args[1].copy_(torch.randint(0, cfg.vocab_size, args[1].shape))
        with torch.no_grad(), ops.use_policy(ops.policy_named("cuda")):
            _, fwd[device] = count_cost(fn, *args)
    assert fwd["meta"].flops == fwd["cpu"].flops
    for k, v in fwd["cpu"].by_scope.items():
        assert fwd["meta"].by_scope[k]["flops"] == v["flops"], k
    # bytes: the one step's output is expanded to the loop's length, not
    # stacked from n outputs (n - 1 fewer reads of a step's output)
    assert abs(fwd["meta"].bytes_accessed - fwd["cpu"].bytes_accessed) \
        <= 0.02 * fwd["cpu"].bytes_accessed


# ------------------------------------------------- against the reference


def _reference_scopes(arch):
    cfg = jconfigs.get(arch, smoke=True)
    with juse_policy(jpolicy_named("xla")):
        if arch == "m3vit":
            params = JV.init_params(jax.random.PRNGKey(0), cfg)
            x = jnp.zeros((8, 128, 256, 3), jnp.float32)
            fn = lambda p, x: JV.forward(p, x, cfg, "semseg")[0]  # noqa
        else:
            params = JM.init_params(jax.random.PRNGKey(0), cfg)
            x = jnp.zeros((4, 256), jnp.int32)
            fn = lambda p, x: JM.forward(p, x, cfg)[0]  # noqa
        text = jax.jit(fn).lower(params, x).compile().as_text()
    return analyze_hlo_text(text)


@pytest.mark.parametrize("arch", ["m3vit", "llama3_2_1b",
                                  "llama4_scout_17b_a16e", "xlstm_350m"])
def test_flops_by_scope_match_the_reference_hlo(arch):
    ref = _reference_scopes(arch)
    fn = _m3vit_forward("eager", b=8) if arch == "m3vit" else \
        _lm_forward(arch, "eager", b=4, s=256)
    with torch.no_grad():
        _, got = count_cost(fn)
    rows = []
    for scope in sorted(set(ref.by_scope) | set(got.by_scope)):
        r = ref.by_scope.get(scope, {}).get("flops", 0.0)
        g = got.by_scope.get(scope, {}).get("flops", 0.0)
        held = scope != "other" and r >= SCOPE_SHARE * ref.flops
        rows.append((scope, r, g, held))
    print(f"\n{arch}: total reference {ref.flops:.4e} port {got.flops:.4e}")
    for scope, r, g, held in rows:
        print(f"  {scope:12s} {r:.4e} {g:.4e} {'held' if held else ''}")
    assert abs(got.flops - ref.flops) <= TOL * ref.flops
    for scope, r, g, held in rows:
        if held:
            assert abs(g - r) <= TOL * r, (scope, r, g)


def test_analyze_step_reports_against_the_h100():
    fn = _lm_forward("llama3_2_1b", "eager")
    cfg = tconfigs.get("llama3_2_1b", smoke=True)
    with torch.no_grad():
        report, _ = TA.analyze_step(fn, (), cfg, TSHAPES["prefill_32k"])
    assert report.mesh == "1xH100" and report.chips == 1
    assert report.t_compute == report.hlo_flops / 989e12
    assert report.t_memory == report.hlo_bytes / 3.35e12
    assert report.collective_bytes == 0 and report.t_collective == 0
    assert report.bottleneck in ("compute", "memory")
    d = report.to_dict()
    assert d["t_roofline"] == max(d["t_compute"], d["t_memory"])
    # the flash kernel's bytes are the reference's arithmetic exactly;
    # the adjusted terms read them against the H100's constants
    adj = TA.kernel_adjusted_terms(d, cfg, TSHAPES["prefill_32k"])
    assert adj["flash_kernel_bytes"] == JA.flash_kernel_bytes(
        jconfigs.get("llama3_2_1b", smoke=True), JSHAPES["prefill_32k"], 1)
    assert adj["t_memory"] == adj["hlo_bytes_adjusted"] / 3.35e12


def test_counter_is_off_outside_its_block():
    assert op_cost.active() is None
    with CostCounter() as c:
        assert op_cost.active() is c
    assert op_cost.active() is None
