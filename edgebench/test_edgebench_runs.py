"""Whole runs of every cell on the CPU at tiny sizes (the harness past its
look for a card): ``correct`` holds on the sound program and comes out
false with the timed path broken underneath, once for each fault a cell
can have; the float8 control reads well above the program; and a cell
defined only by new files runs."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

import run as RUN
from ebench import manifest as M
from ebench import tiny

SEED = 2**31 + 77
# the listed cells, and two whose files are there and whose entries are
# not (a closed-loop chat mix and the open-loop cameras)
CELLS = [w["name"] for w in M.load()["workloads"]] \
    + ["deepseek_67b.chat-c32", "m3vit.cameras-open"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("edgebench_tiny")


@pytest.fixture(scope="module")
def manifest(root):
    return tiny.write_root(root)


def measure(manifest, cell, trace=False, seed=SEED, **kw):
    return RUN.measure(cell, seed, 1.0, trace, "cpu", time.perf_counter(),
                       manifest=manifest, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(manifest, cell):
    line, out = measure(manifest, cell)
    assert line["correct"], line["check"]
    assert out["sampled"] > 0 and line["failed"] == 0
    assert line["attempted"] > 0
    e2e = {m["name"] for m in M.end_to_end(manifest, cell)}
    assert set(line["metrics"]) == e2e
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "check"


@pytest.mark.parametrize("cell", [w["name"] for w in M.load()["workloads"]])
def test_traced_run_reads_its_per_layer_metrics(manifest, cell):
    line, _ = measure(manifest, cell, trace=True)
    assert line["correct"]
    names = {m["name"] for m in M.per_layer(manifest, cell)}
    # the CPU has no device trace and no peak: what is left is counted
    assert set(line["metrics"]) <= names and line["metrics"]
    assert line["device"]["window_s"] > 0
    assert "breakdown" in line


def _vision_fault(monkeypatch, how):
    from repro_torch.serve.vision import M3ViTServer

    real = M3ViTServer.infer

    def infer(self, images, task):
        if how == "answer":
            return -real(self, images, task)
        half = images.shape[0] // 2
        out = real(self, images[:half], task)
        return np.concatenate([out, out])

    monkeypatch.setattr(M3ViTServer, "infer", infer)


def _lm_fault(monkeypatch, how):
    from repro_torch.models import layers
    from repro_torch.serve.scheduler import LMBackend

    if how == "state":
        real_upd = layers._upd_cache

        def upd(c, new, slot):
            if isinstance(slot, torch.Tensor) and slot.dim() == 1:
                return c            # the decode step writes nothing
            return real_upd(c, new, slot)

        monkeypatch.setattr(layers, "_upd_cache", upd)
        return
    real = LMBackend.decode_step

    def decode_step(self):
        fn = real(self)

        def decode(params, toks, state, cache_pos, task_ids):
            tok, state, counts = fn(params, toks, state, cache_pos, task_ids)
            if how == "token":
                tok = (tok + 1) % self.cfg.vocab_size
            else:
                half = tok.shape[0] // 2
                tok = torch.cat([tok[:half], tok[:tok.shape[0] - half]])
            return tok, state, counts
        return decode

    monkeypatch.setattr(LMBackend, "decode_step", decode_step)


FAULTS = [("m3vit.pairs-c256", "answer"), ("m3vit.pairs-c256", "half")] + [
    (cell, how) for cell in ("deepseek_67b.rag-c32", "deepseek_67b.chat-c32")
    for how in ("token", "state", "half")]


@pytest.mark.parametrize("cell,how", FAULTS)
def test_broken_timed_path_is_not_correct(manifest, monkeypatch, cell, how):
    if cell.startswith("m3vit"):
        _vision_fault(monkeypatch, how)
    else:
        _lm_fault(monkeypatch, how)
    line, _ = measure(manifest, cell)
    assert not line["correct"], line["check"]


def _held_weights(monkeypatch):
    """The run's configuration and weights, as the driver draws them."""
    from ebench import weights

    held, real = {}, weights.draw

    def draw(cfg, seed, device):
        held["cfg"], held["params"] = cfg, real(cfg, seed, device)
        return held["params"]

    monkeypatch.setattr(weights, "draw", draw)
    return held


def _vision_control(monkeypatch):
    """Every answer the float8 reference's, in the server's place."""
    from repro_torch.serve.vision import M3ViTServer

    held = _held_weights(monkeypatch)

    def infer(self, images, task):
        ref = M.reference(held["cfg"])
        x = torch.as_tensor(np.asarray(images), dtype=torch.float32)
        with torch.no_grad():
            return ref.forward(held["params"], held["cfg"], x, int(task),
                               mode="fp8").numpy()

    monkeypatch.setattr(M3ViTServer, "infer", infer)


def _lm_control(monkeypatch):
    """The sampled requests' served tokens the float8 reference's greedy
    ones, in the engine's place."""
    from ebench import lm

    held, real = _held_weights(monkeypatch), lm.pick

    def pick(served, requests, tokens, seed):
        ref = M.reference(held["cfg"])
        out = []
        for prompt, toks in real(served, requests, tokens, seed):
            seq = torch.as_tensor(np.asarray(prompt, np.int64))
            for _ in toks:
                with torch.no_grad():
                    row = ref.logits_at(held["params"], held["cfg"], seq,
                                        [len(seq) - 1], mode="fp8")
                seq = torch.cat([seq, row.argmax(-1)])
            out.append((prompt, seq[len(prompt):].tolist()))
        return out

    monkeypatch.setattr(lm, "pick", pick)


@pytest.mark.parametrize("cell", [w["name"] for w in M.load()["workloads"]])
def test_control_in_the_programs_place_is_not_correct(manifest, monkeypatch,
                                                      cell):
    """The harness's own check decides the float8 control, on three
    seeds."""
    if cell.startswith("m3vit"):
        _vision_control(monkeypatch)
    else:
        _lm_control(monkeypatch)
    for seed in (11, 12, 13):
        line, _ = measure(manifest, cell, seed=seed)
        assert not line["correct"], (seed, line["check"])


@pytest.mark.parametrize("cell", ["m3vit.pairs-c256", "deepseek_67b.chat-c32",
                                  "deepseek_67b.rag-c32"])
def test_control_reads_well_above_the_program(manifest, cell):
    """The reference in float8 in the program's place, on three seeds."""
    for seed in (11, 12, 13):
        _, out = measure(manifest, cell, seed=seed, control=True)
        (name, (program, _)), = out["checks"].items()
        assert out["control"][name] >= 3 * program, (seed, out["control"],
                                                      program)


def test_a_cell_defined_only_by_files(tmp_path):
    """A new configuration, traffic mix and per-layer metric as files and
    entries, and no edit to the harness."""
    m = M.load()
    m.pop("_root")
    base = m["configs"][0]
    m["configs"] = [dict(base, name="m3vit_b", file="edgebench/configs/"
                         "m3vit_b.json")]
    m["workloads"] = [{"name": "m3vit_b.pairs-new", "config": "m3vit_b",
                       "traffic": "pairs-new", "chips": 1, "why": "test"}]
    for e in m["end_to_end"]:
        e.pop("workloads", None)
    m["end_to_end"] = [e for e in m["end_to_end"]
                       if e["name"] in ("frames_per_s", "setup_s")]
    m["per_layer"] = [{"name": "frames.count", "unit": "frames",
                       "better": "higher", "source": "program_counter",
                       "layer": "serving front", "moves": "frames_per_s"}]
    shutil.copytree(M.ROOT / "edgebench" / "reference",
                    tmp_path / "edgebench" / "reference")
    (tmp_path / "edgebench" / "configs").mkdir()
    (tmp_path / "edgebench" / "traffic").mkdir()
    (tmp_path / "edgebench" / "metrics").mkdir()
    cfg = json.loads((M.ROOT / base["file"]).read_text())
    cfg.update(tiny.TINY_CONFIGS["m3vit"], num_layers=4)
    (tmp_path / "edgebench/configs/m3vit_b.json").write_text(json.dumps(cfg))
    tr = dict(tiny.TINY_TRAFFIC["pairs-c256"], clients=6)
    (tmp_path / "edgebench/traffic/pairs-new.json").write_text(
        json.dumps(tr))
    (tmp_path / "edgebench/metrics/frames.count.py").write_text(
        "def read(run):\n    return run.counters['bucket_slot_steps']\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    mm = M.load(tmp_path)
    line, _ = measure(mm, "m3vit_b.pairs-new")
    assert line["correct"] and set(line["metrics"]) == {"frames_per_s",
                                                        "setup_s"}
    line, _ = measure(mm, "m3vit_b.pairs-new", trace=True)
    assert line["metrics"]["frames.count"]["value"] > 0
