"""The one-card dry-run (``repro_torch.launch.dryrun``) and its tables
(``repro_torch.roofline.report``), on ``meta`` on the CPU.

* ``input_specs`` gives the reference's input shapes and dtypes for every
  runnable cell, and ``param_specs`` the parameters ``init_params``
  draws, key for key, on ``meta``.
* One tiny cell per family — dense (Llama-3.2-1B), MoE (Llama-4-Scout),
  recurrent (xLSTM-350M, RecurrentGemma-9B), M-RoPE (Qwen2-VL-72B) and
  embedding inputs (MusicGen-Large) — in train, prefill and decode, at
  the smoke config: each completes on ``meta``, writes its JSON, and the
  report renders both tables from them.
* The counts on ``meta`` equal the counts of the same step on real CPU
  tensors (the counter sees shapes, not values): the FLOPs exactly, the
  bytes and the peak of live bytes within 0.1 % (a few ops decompose
  differently on meta).
* ``--list`` prints the reference's cells.
* Mesh cells (rank 0's share on the device-free production meshes):
  Llama-3.2-1B ``train_4k`` at 16×16 and 2×16×16 holds the argument
  bytes the sharding factors predict, receives collective bytes (no
  dense all-gather over ``data`` under ``--no-fsdp``), runs the dense
  blocks tensor-parallel (its FLOPs the one-card count over the batch
  shards and the model axis but the whole k/v's, derived from the leaves
  ``model`` splits; the model all-reduces counted; no gather over
  ``model`` but of the whole k/v), and ``--seq-shard`` changes no
  count; Llama-4-Scout under ``ep_local`` records its all-reduce over
  ``model``; the flags run from the command line; one-card cells record
  no collective.  The serving cells on a mesh run the dense blocks
  tensor-parallel: Llama-3.2-1B's and DeepSeek-67B's prefill and decode
  at 16×16 count the one-card FLOPs over the batch shards and the model
  axis (within the k/v projections every rank repeats where the KV heads
  do not divide it), hold a rank's blocks of the weights, and record the
  model axis's all-reduces and the logits' all-gather; RecurrentGemma-9B's
  split its RG-LRU mixers too (the ``rglru`` scope's FLOPs over the model
  axis, one float32 all-reduce of a rank's rows a mixer, the argument
  bytes of its blocks and of its state's channels exactly), and so does
  its ``train_4k`` cell (the backward's ``f`` on each mixer's input
  counted besides).  xLSTM-350M's 4 heads do not divide 16, so its mesh
  cells keep every mixer leaf whole: the ``mlstm``/``slstm`` scopes'
  FLOPs are the one-card count over the batch shards alone, with no
  collective of theirs.  A serving cell holds its weights where
  ``serve.engine.place_params`` puts them: under the default FSDP rules
  DeepSeek-67B's 16×16 decode cell gathers the table's data-split leaves
  once each over data, under the ``fsdp_gather`` scope (``--no-fsdp``:
  nothing over data).
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import ops
from repro_torch.configs.base import SHAPES, Shape
from repro_torch.launch import dryrun
from repro_torch.models import model as TM
from repro_torch.roofline import report
from repro_torch.roofline.op_cost import count_cost
from test_torch_threads import one_torch_thread  # noqa: F401

FAMILIES = ["llama3_2_1b", "llama4_scout_17b_a16e", "xlstm_350m",
            "recurrentgemma_9b", "qwen2_vl_72b", "musicgen_large"]
TINY = {"train": Shape("tiny_train", "train", 32, 4),
        "prefill": Shape("tiny_prefill", "prefill", 32, 2),
        "decode": Shape("tiny_decode", "decode", 48, 2)}


def _spec(x):
    return tuple(x.shape), str(x.dtype).split(".")[-1]


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a, s, runnable in jconfigs.cells() if runnable])
def test_input_specs_match_the_reference(arch, shape):
    want = JM.input_specs(jconfigs.get(arch), JSHAPES[shape])
    got = TM.input_specs(tconfigs.get(arch), SHAPES[shape])
    assert set(got) == set(want)
    for k in ("inputs", "labels", "cache_index"):
        if k in want:
            w = want[k]
            assert _spec(got[k]) == (tuple(w.shape), str(w.dtype))
            assert got[k].device.type == "meta"
    if "state" in want:
        flat = jax.tree_util.tree_leaves(want["state"])
        leaves = []
        stack = [got["state"]]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack.extend(t.values())
            else:
                leaves.append(t)
        assert sorted(t.numel() for t in leaves) \
            == sorted(int(np.prod(w.shape)) for w in flat)


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_specs_are_init_params_on_meta(arch):
    cfg = tconfigs.get(arch, smoke=True)
    spec = TM.param_specs(cfg)
    real = TM.init_params(0, cfg, device="cpu")
    assert list(spec) == list(real)
    for k, v in real.items():
        assert spec[k].device.type == "meta"
        assert (spec[k].shape, spec[k].dtype) == (v.shape, v.dtype), k


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_tiny_cell_completes_and_renders(arch, kind, tmp_path):
    rec = dryrun.run_cell(arch, "", out_dir=str(tmp_path), verbose=False,
                          variant={"accum": 2}, smoke=True,
                          shape=TINY[kind])
    assert rec["ok"] and rec["mesh"] == "1xH100" and rec["chips"] == 1
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["argument_bytes"] > 0 and rec["temp_bytes"] > 0
    assert rec["fits"] == (rec["argument_bytes"] + rec["temp_bytes"]
                           <= rec["hbm_bytes"])
    assert rec["t_compute"] == rec["hlo_flops"] / 989e12
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    loaded = json.loads(files[0].read_text())
    assert loaded["arch"] == arch and loaded["shape"] == TINY[kind].name
    recs = report.load(str(tmp_path))
    table = report.dryrun_table(recs)
    roof = report.roofline_table(recs)
    assert f"| {arch} | {TINY[kind].name} | 1xH100 |" in table
    assert f"| {arch} | {TINY[kind].name} |" in roof
    assert report.scope_summary(recs[0])


def _fill(args, vocab):
    """Real CPU values for a cell's CPU arguments (seeded): the counts do
    not depend on them, but the plain versions must not see NaNs."""
    g = np.random.default_rng(0)
    stack = [args]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and 0 not in t.stride():
            if t.is_floating_point():
                t.copy_(torch.from_numpy(
                    g.standard_normal(t.shape).astype(np.float32) * 0.1))
            else:
                t.copy_(torch.from_numpy(g.integers(0, 8, t.shape)))


@pytest.mark.parametrize("arch", ["llama3_2_1b", "llama4_scout_17b_a16e"])
def test_meta_counts_equal_the_cpu_run(arch):
    for kind in ("prefill", "decode", "train"):
        costs = {}
        for device in ("meta", "cpu"):
            fn, args, cfg, _ = dryrun.build_cell(
                arch, "", {"accum": 1}, smoke=True, shape=TINY[kind],
                device=device)
            if device == "cpu":
                _fill(args, cfg.vocab_size)
                if kind == "decode":   # the scalar index, as a position
                    args = args[:3] + (torch.full((2,), 40),)
            with ops.use_policy(ops.policy_named("eager")):
                if kind == "train":
                    _, costs[device] = count_cost(fn, *args)
                else:
                    with torch.no_grad():
                        _, costs[device] = count_cost(fn, *args)
        meta, cpu = costs["meta"], costs["cpu"]
        assert meta.flops == cpu.flops, kind
        # bytes within 0.1 %: a few ops decompose differently on meta
        # (``one_hot``: compares on meta, a scatter on the CPU)
        assert abs(meta.bytes_accessed - cpu.bytes_accessed) \
            <= 1e-3 * cpu.bytes_accessed, kind
        assert abs(meta.peak_live_bytes - cpu.peak_live_bytes) \
            <= 1e-3 * cpu.peak_live_bytes, kind


@functools.lru_cache(maxsize=None)
def _mesh_cell(arch, mesh, **variant):
    return dryrun.run_cell(arch, "train_4k", verbose=False, mesh=mesh,
                           variant=variant)


@pytest.mark.parametrize("flag", ["--multi-pod", "--no-fsdp",
                                  "--fsdp-moe-only", "--seq-shard"])
def test_mesh_flags_name_the_distribution_slice(flag, tmp_path):
    """Each of the reference's mesh flags runs a mesh cell (the
    reference's flags imply its 16×16 mesh; ``--multi-pod`` is
    2×16×16), written under the mesh's name with the flag as its tag."""
    assert dryrun.main(["--arch", "llama3_2_1b", "--shape", "train_4k",
                        flag, "--out", str(tmp_path)]) == 0
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    mesh = "2x16x16" if flag == "--multi-pod" else "16x16"
    assert rec["mesh"] == mesh and rec["collective_bytes"] > 0
    assert rec["chips"] == (512 if flag == "--multi-pod" else 256)
    assert "tensor-parallel over model in training" in rec["mesh_note"]


def _predicted_argument_bytes(mesh_name, fsdp=True):
    """Parameters, AdamW state and the local input rows of rank 0, from
    the rule table's specs of the whole shapes and the mesh's sizes."""
    from repro_torch.dist.sharding import (ShardingRules, _trim_spec,
                                           axis_sizes, param_sharding_rules)

    mesh = dryrun.mesh_named(mesh_name)
    rules = ShardingRules.for_mesh(mesh, fsdp=fsdp)
    sizes = axis_sizes(mesh)
    params = TM.param_specs(tconfigs.get("llama3_2_1b"))
    total = 4                                        # the step counter
    for name, sh in param_sharding_rules(params, rules).items():
        n = params[name].numel()
        for entry in sh.spec:
            for a in (() if entry is None else (entry,) if
                      isinstance(entry, str) else entry):
                n //= sizes[a]
        total += n * (params[name].element_size() + 8)   # p, m, v
    shape = SHAPES["train_4k"]
    (entry,) = _trim_spec((shape.global_batch,), (rules.batch_entry,), mesh)
    shards = 1
    for a in (entry,) if isinstance(entry, str) else entry:
        shards *= sizes[a]
    return total + 2 * 4 * shape.seq_len * shape.global_batch // shards


def _whole_over_model(mesh_name):
    """(the leaves ``model`` splits, the leaves whose spec names ``model``
    but which a rank holds whole: k/v where the KV heads do not divide the
    axis) of Llama-3.2-1B's train cell on the mesh."""
    from repro_torch.dist.sharding import ShardingRules, param_sharding_rules
    from repro_torch.models.transformer import model_blocks

    cfg = tconfigs.get("llama3_2_1b")
    rules = ShardingRules.for_mesh(dryrun.mesh_named(mesh_name))
    params = TM.param_specs(cfg)
    split = model_blocks(cfg, rules)
    whole = [k for k, sh in param_sharding_rules(params, rules).items()
             if k not in split and any(
                 "model" in ((e,) if isinstance(e, str) else e or ())
                 for e in sh.spec)]
    return params, split, whole


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_mesh_cell_bytes_and_collectives(mesh):
    rec = _mesh_cell("llama3_2_1b", mesh)
    one = _mesh_cell("llama3_2_1b", "1")
    assert rec["argument_bytes"] == _predicted_argument_bytes(mesh)
    assert rec["mesh"] == mesh and rec["collective_bytes"] > 0
    assert rec["t_collective"] > 0
    kinds = rec["collectives"]
    assert kinds["all_gather"]["by_axis"]["data"] > 0
    assert kinds["reduce_scatter"]["by_axis"]["data"] > 0
    assert rec["collective_bytes"] == sum(v["bytes"] for v in kinds.values())
    # the dense blocks are tensor-parallel: the blocks' all-reduces over
    # model are counted, and the only gathers over model are of the
    # leaves a rank holds whole (k/v: 8 KV heads do not divide 16) — no
    # split leaf, no logits
    params, split, whole = _whole_over_model(mesh)
    tp = 16
    assert split and sorted(k.rsplit(".", 1)[1] for k in whole) == ["wk",
                                                                    "wv"]
    assert kinds["all_reduce"]["by_axis"]["model"] > 0
    assert kinds["all_gather"]["by_axis"]["model"] == sum(
        params[k].numel() * params[k].element_size() for k in whole)
    # a rank's FLOPs: the one-card count over the model axis, but the
    # whole leaves' products (forward, input and weight gradients: 6 a
    # weight a token) on every model rank, over the batch's shards
    shards = rec["batch_shards"]
    assert shards == (16 if mesh == "16x16" else 32)
    shape = SHAPES["train_4k"]
    tokens = shape.global_batch * shape.seq_len
    repeated = sum(6 * tokens * params[k].numel() for k in whole)
    want = (one["hlo_flops"] / tp + (1 - 1 / tp) * repeated) / shards
    assert abs(rec["hlo_flops"] / want - 1) < 0.01
    assert rec["bottleneck"] == max(
        ("compute", "memory", "collective"), key=lambda t: rec[f"t_{t}"])
    # the one-card cell records no collective
    assert one["mesh"] == "1xH100" and one["chips"] == 1
    assert one["collective_bytes"] == 0 and one["collectives"] == {}


def test_mesh_cell_without_fsdp_gathers_nothing_over_data():
    rec = _mesh_cell("llama3_2_1b", "16x16", no_fsdp=True)
    assert rec["argument_bytes"] == _predicted_argument_bytes("16x16",
                                                              fsdp=False)
    kinds = rec["collectives"]
    assert "data" not in kinds["all_gather"]["by_axis"]
    assert "reduce_scatter" not in kinds
    assert kinds["all_reduce"]["by_axis"]["data"] > 0   # the gradients
    assert rec["argument_bytes"] > _mesh_cell("llama3_2_1b",
                                              "16x16")["argument_bytes"]


def test_seq_shard_changes_no_count():
    a = _mesh_cell("llama3_2_1b", "16x16", seq_shard=True)
    b = _mesh_cell("llama3_2_1b", "16x16")
    for k in ("hlo_flops", "hlo_bytes", "collective_bytes",
              "argument_bytes"):
        assert a[k] == b[k], k
    assert a["seq_shard"] and not b["seq_shard"]


def test_ep_local_records_its_model_all_reduce():
    rec = _mesh_cell("llama4_scout_17b_a16e", "16x16", moe_impl="ep_local")
    assert rec["collectives"]["all_reduce"]["by_axis"]["model"] > 0
    # expert stacks stay local over model: gathered over data only
    assert rec["collectives"]["all_gather"]["by_axis"]["data"] > 0


def test_attn_block_k_names_the_schedules(tmp_path):
    """``--attn-block-k`` runs blocked attention at that block through the
    policy's tiles (``ops/schedules.py``), as the reference's does."""
    _, _, cfg, _ = dryrun.build_cell("llama3_2_1b", "",
                                     {"attn_block_k": 256}, smoke=True,
                                     shape=TINY["prefill"])
    assert cfg.policy.impl_for("attention") == "blocked"
    assert cfg.policy.tile_for("attention") == {"block_k": 256}
    rec = dryrun.run_cell("llama3_2_1b", "", out_dir=str(tmp_path),
                          verbose=False, variant={"attn_block_k": 256},
                          smoke=True, shape=TINY["prefill"])
    assert rec["ok"] and rec["hlo_flops"] > 0


def test_list_prints_the_reference_cells(capsys):
    assert dryrun.main(["--list"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(jconfigs.cells(include_skipped=True))


def test_opt_config_rule_is_the_reference():
    """The reference's ``opt_config_for`` (``launch/dryrun.py``, not
    imported here: its import forces 512 host devices): above 30 B
    parameters bf16 momentum and a factored second moment."""
    for arch in tconfigs.list_archs():
        got = dryrun.opt_config_for(tconfigs.get(arch))
        big = tconfigs.get(arch).param_count() > 3e10
        assert got.factored == big
        assert got.momentum_dtype == ("bfloat16" if big else "float32")


@functools.lru_cache(maxsize=None)
def _serve_cell(arch, shape, mesh):
    return dryrun.run_cell(arch, shape, verbose=False, mesh=mesh)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["llama3_2_1b", "deepseek_67b"])
def test_mesh_serving_cells_split_the_dense_blocks(arch, shape):
    """A rank's share of a serving cell at 16×16: its rows of the batch
    and its block over ``model`` of every dense leaf.  Each dense scope's
    FLOPs (attention's scores and values, its output projection, the MLP,
    the head) are the one-card count over the batch shards and the model
    axis; the q/k/v projections over the shards alone times the share a
    rank computes, its q heads and every KV head (8 KV heads do not
    divide 16); the norms are repeated by every model rank.  The model
    axis carries the blocks' all-reduces and the logits' all-gather, and
    a rank holds its blocks of the weights."""
    rec = _serve_cell(arch, shape, "16x16")
    one = _serve_cell(arch, shape, "1")
    cfg = tconfigs.get(arch)
    tp = 16
    shards = rec["batch_shards"]

    def share(scope):
        return rec["by_scope"][scope]["flops"] * shards \
            / one["by_scope"][scope]["flops"]

    attn = ("attn_decode",) if shape.startswith("decode") \
        else ("attn_scores", "attn_pv")
    for scope in attn + ("attn_out", "mlp", "lm_head"):
        assert share(scope) == pytest.approx(1 / tp, rel=1e-6), scope
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    assert share("attn_qkv") == pytest.approx(
        (hq // tp + 2 * hkv) / (hq + 2 * hkv), rel=1e-6)
    assert share("norm") == pytest.approx(1.0, rel=1e-6)
    model = {k: v["by_axis"].get("model", 0)
             for k, v in rec["collectives"].items()}
    assert model["all_reduce"] > 0 and model["all_gather"] > 0, model
    assert "tensor-parallel" in rec["mesh_note"]
    # the weights a rank holds: its blocks plus the whole k/v, norms
    weights = TM.param_specs(cfg)
    whole = sum(t.numel() * t.element_size() for t in weights.values())
    kv = sum(t.numel() * t.element_size() for k, t in weights.items()
             if k.endswith(("attn.wk", "attn.wv")))
    state = one["argument_bytes"] - whole
    assert rec["argument_bytes"] < (whole - kv) / tp + kv + state


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_mesh_serving_cells_split_the_rglru_mixers(shape):
    """RecurrentGemma-9B's serving cells at 16×16 (4096 channels over 16
    gate heads split 16 ways): the ``rglru`` scope's FLOPs are the
    one-card count over the batch shards and the model axis, its one
    ``rglru_down`` all-reduce a mixer moves the rank's (B, S, d) float32
    rows, and the rank's argument bytes are its blocks of the weights, its
    state at 256 channels a mixer and its inputs, exactly."""
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.serve.engine import fsdp_gathers, place_params
    from repro_torch.tree import flatten

    rec = _serve_cell("recurrentgemma_9b", shape, "16x16")
    one = _serve_cell("recurrentgemma_9b", shape, "1")
    cfg = tconfigs.get("recurrentgemma_9b")
    tp, shards = 16, rec["batch_shards"]
    scope = rec["by_scope"]["rglru"]
    # within the work on ``lam`` alone (per channel, not per row), which
    # every batch shard repeats
    assert scope["flops"] * shards / one["by_scope"]["rglru"]["flops"] \
        == pytest.approx(1 / tp, rel=1e-4)
    s = SHAPES[shape]
    b = s.global_batch // shards
    rows = b * (s.seq_len if s.kind == "prefill" else 1)
    mixers = sum(cfg.block_kind(i) == "rglru_mlp"
                 for i in range(cfg.num_layers))
    assert mixers == 26
    assert scope["collective_bytes"] == mixers * rows * cfg.d_model * 4
    rules = ShardingRules.for_mesh(dryrun.mesh_named("16x16"))
    held = place_params(TM.param_specs(cfg), cfg, rules)
    state = flatten(TM.init_state(cfg, b, s.seq_len, device="meta",
                                  params=held, gather=fsdp_gathers(
                                      held, cfg, rules)))
    inputs = rows * 4 + (b * 4 if s.kind == "decode" else 0)
    assert rec["argument_bytes"] == sum(
        t.numel() * t.element_size()
        for t in list(held.values()) + list(state.values())) + inputs


def test_mesh_decode_cell_gathers_the_fsdp_leaves_once():
    """DeepSeek-67B's ``decode_32k`` cell at 16×16 under the default FSDP
    rules: its all-gathers over data move exactly the table's
    data-split leaves once each (a decode cell is one forward), each at
    its block over model — the shape the rank computes on, whole over
    model where it computes a leaf whole (k/v: 8 KV heads over 16) — all
    under the ``fsdp_gather`` scope with the model gathers of those whole
    leaves; ``--no-fsdp`` gathers nothing over data and holds more."""
    from repro_torch.dist.sharding import (ShardingRules, _axes,
                                           param_sharding_rules)
    from repro_torch.models import transformer as T

    cfg = tconfigs.get("deepseek_67b")
    rec = _serve_cell("deepseek_67b", "decode_32k", "16x16")
    rules = ShardingRules.for_mesh(dryrun.mesh_named("16x16"))
    blocks = T.model_blocks(cfg, rules)
    shapes = TM.param_specs(cfg)
    data = model = 0
    for name, sh in param_sharding_rules(shapes, rules).items():
        axes = [a for e in sh.spec for a in _axes(e)]
        if "data" not in axes:
            continue
        nbytes = shapes[name].numel() * shapes[name].element_size()
        if "model" in axes and name in blocks:
            data += nbytes // 16
        else:
            data += nbytes // 16 if "model" in axes else nbytes
            model += nbytes * ("model" in axes)
    by_axis = rec["collectives"]["all_gather"]["by_axis"]
    assert by_axis["data"] == data
    rows = SHAPES["decode_32k"].global_batch // rec["batch_shards"]
    logits = rows * cfg.vocab_size * 4          # the rank's float32 rows
    assert by_axis["model"] == model + logits
    assert rec["by_scope"]["fsdp_gather"]["collective_bytes"] == data + model
    off = dryrun.run_cell("deepseek_67b", "decode_32k", verbose=False,
                          mesh="16x16", variant={"no_fsdp": True})
    assert "data" not in off["collectives"]["all_gather"]["by_axis"]
    assert "fsdp_gather" not in off["by_scope"]
    assert off["argument_bytes"] > rec["argument_bytes"]


def test_mesh_train_cell_splits_the_rglru_mixers():
    """RecurrentGemma-9B's ``train_4k`` cell at 16×16: the ``rglru``
    scope's FLOPs (forward and backward) are the one-card count over the
    batch shards and the model axis; each microbatch records a mixer's
    ``rglru_down`` all-reduce of the rank's float32 rows in the forward
    and its input's bf16 gradient all-reduce (the ``f``) in the backward,
    and the scope's collective bytes are the forward's over the
    ``accum`` microbatches."""
    cfg = tconfigs.get("recurrentgemma_9b")
    ops.reset_dispatch_report()
    rec = dryrun.run_cell("recurrentgemma_9b", "train_4k", verbose=False,
                          mesh="16x16")
    where = {c["where"]: (c["count"], c["bytes"])
             for c in ops.collective_report()}
    one = _mesh_cell("recurrentgemma_9b", "1")
    tp, shards = 16, rec["batch_shards"]
    assert rec["by_scope"]["rglru"]["flops"] * shards \
        / one["by_scope"]["rglru"]["flops"] == pytest.approx(1 / tp,
                                                             rel=1e-6)
    s = SHAPES["train_4k"]
    rows = s.global_batch // shards // dryrun.TRAIN_ACCUM * s.seq_len
    mixers = sum(cfg.block_kind(i) == "rglru_mlp"
                 for i in range(cfg.num_layers))
    assert where["rglru_down all-reduce"] == (
        mixers, mixers * rows * cfg.d_model * 4)
    assert where["rglru input (backward)"] == (
        mixers, mixers * rows * cfg.d_model * 2)
    assert rec["by_scope"]["rglru"]["collective_bytes"] == \
        dryrun.TRAIN_ACCUM * mixers * rows * cfg.d_model * 4


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_mesh_cells_keep_the_xlstm_mixers_whole(shape):
    """xLSTM-350M at 16×16: ``model`` (16) does not divide its 4 heads
    (``xlstm.split_over``), so every mixer leaf stays whole on a rank —
    none is among ``model_blocks`` — and the ``mlstm`` and ``slstm``
    scopes keep their counts: the one-card FLOPs over the batch shards
    alone, no collective recorded inside a mixer."""
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as XL

    cfg = tconfigs.get("xlstm_350m")
    rules = ShardingRules.for_mesh(dryrun.mesh_named("16x16"))
    assert not XL.split_over(cfg, 16)
    assert not any(".mlstm." in k or ".slstm." in k
                   for k in T.model_blocks(cfg, rules))
    ops.reset_dispatch_report()
    rec = dryrun.run_cell("xlstm_350m", shape, verbose=False, mesh="16x16")
    where = {c["where"] for c in ops.collective_report()}
    one = dryrun.run_cell("xlstm_350m", shape, verbose=False, mesh="1")
    shards = rec["batch_shards"]
    for scope in ("mlstm", "slstm"):
        assert rec["by_scope"][scope]["flops"] * shards == pytest.approx(
            one["by_scope"][scope]["flops"], rel=1e-6), scope
        assert not rec["by_scope"][scope].get("collective_bytes"), scope
    assert not any(w.startswith(("mlstm", "slstm")) for w in where), where
