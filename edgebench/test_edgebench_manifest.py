"""``BENCHMARK.json`` against the benchmark's contract, every cell's files
found by name, and the import rules of the benchmark's sources."""

import ast
import json
from pathlib import Path

import pytest

from ebench import manifest as M

ROOT = M.ROOT
BENCH = ROOT / "edgebench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == TOP_KEYS
    assert MANIFEST["paths"] == ["edgebench"]
    assert MANIFEST["command"] == ["python3", "edgebench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str)
                         else x["name"])
def test_names_units_and_keys(group, entry):
    assert M.NAME.fullmatch(entry["name"])
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[group]
    assert set(entry) <= allowed
    if group in ("end_to_end", "per_layer"):
        assert M.UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "workloads":
        assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
        assert entry["chips"] in (1, 4)
        assert M.NAME.fullmatch(entry["traffic"])
    if group == "configs":
        assert all(M.NAME.fullmatch(k) for k in entry["reduced"])


def test_names_are_unique_and_every_config_is_used():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in MANIFEST["end_to_end"]
               + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    m = M.load()
    entry = M.cell(m, cell)
    cfg = M.config(m, entry)
    assert (ROOT / cfg["reference"]).is_file()
    assert (BENCH / "ebench" / f"{cfg['driver']}.py").is_file()
    assert M.traffic(m, entry)["loop"] in ("closed", "open")
    e2e = {x["name"] for x in M.end_to_end(m, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = M.per_layer(m, cell)
    assert layers
    for spec in layers:
        assert spec["moves"] in e2e
        assert callable(M.reader(m, spec["name"]).read)


def test_per_layer_metrics_name_existing_cells_and_metrics():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for spec in MANIFEST["per_layer"]:
        assert spec["moves"] in e2e
        assert set(spec.get("workloads", cells)) <= cells
        if spec["name"].split(".")[0].endswith("_roofline") \
                or "mfu" in spec["name"]:
            assert spec["unit"] == "%"


def test_configuration_files_state_their_reductions():
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg.get("published", {}))
        for key in c["reduced"]:
            assert cfg["published"][key] != cfg[key]


SOURCES = sorted(BENCH.rglob("*.py"))
REFERENCES = sorted((BENCH / "reference").glob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    mods = {m.split(".")[0] for m in _imports(path)}
    assert mods <= {"__future__", "contextlib", "math", "torch"}, mods
