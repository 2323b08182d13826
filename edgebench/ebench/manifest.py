"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``BENCHMARK.json``'s configuration
entry (its ``file``: the sizes as run, the driver and the plain reference
it names), ``edgebench/traffic/<traffic>.json`` and, for each per-layer
metric the cell reports, ``edgebench/metrics/<metric name>.py``.  A
configuration names its driver (``ebench/<driver>.py``).  Nothing else is
looked up, so a cell, a configuration or a metric is added by adding files
and entries.  Every lookup is relative to a checkout's root (``root``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load(root: Path = ROOT) -> dict:
    m = json.loads((Path(root) / "BENCHMARK.json").read_text())
    m["_root"] = str(root)
    return m


def _root(m: dict) -> Path:
    return Path(m.get("_root", ROOT))


def cell(manifest: dict, name: str) -> dict:
    """The workload entry of ``name``; a ``<config>.<traffic>`` that is
    not listed but whose files exist runs on one chip (how a cell is
    calibrated and swept before its entry is added)."""
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    config_name, _, mix = name.partition(".")
    if any(c["name"] == config_name for c in manifest["configs"]) and (
            _root(manifest) / "edgebench" / "traffic"
            / f"{mix}.json").is_file():
        return {"name": name, "config": config_name, "traffic": mix,
                "chips": 1}
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, cell_entry: dict) -> dict:
    """The configuration file of the cell's configuration, as run."""
    for c in manifest["configs"]:
        if c["name"] == cell_entry["config"]:
            out = json.loads((_root(manifest) / c["file"]).read_text())
            out["name"] = c["name"]
            out["_root"] = str(_root(manifest))
            return out
    raise KeyError(f"no configuration {cell_entry['config']!r}")


def traffic(manifest: dict, cell_entry: dict) -> dict:
    path = _root(manifest) / "edgebench" / "traffic" \
        / f"{cell_entry['traffic']}.json"
    return json.loads(path.read_text())


def end_to_end(manifest: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in manifest["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(manifest: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, or,
    without a list, those whose ``moves`` metric the cell reports."""
    names = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(manifest: dict, metric_name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``'s
    ``read(run)``, which returns a number or None.  A metric split by
    family (``idle_share.lm``, ``idle_share.vision``) without a file of its
    own is read by its base's, ``metrics/idle_share.py``."""
    metrics = _root(manifest) / "edgebench" / "metrics"
    path = metrics / f"{metric_name}.py"
    if not path.is_file() and "." in metric_name:
        path = metrics / f"{metric_name.rsplit('.', 1)[0]}.py"
    return _load_file(path, "eb_metric_" + re.sub(r"\W", "_", path.stem))


def reference(cfg: dict):
    """The configuration's plain reference (a file under ``edgebench/``)."""
    path = Path(cfg.get("_root", ROOT)) / cfg["reference"]
    return _load_file(path, "eb_reference_" + path.stem)


def driver(cfg: dict):
    return importlib.import_module(f"ebench.{cfg['driver']}")
