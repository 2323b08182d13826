"""Rules the port keeps: it imports nothing of JAX or of the JAX package,
its entry points run on the card unless asked for the CPU, and
``chip_smoke.py`` refuses to report a result without a card or without the
repository around it."""

import ast
import inspect
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import m3vit as TM
from repro_torch.models import model, vit
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.vision import M3ViTServer

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_falls_back_to_the_cpu_by_itself(path):
    text = path.read_text()
    assert not re.search(r"if\s+torch\.cuda\.is_available\(\)\s+else", text)


@pytest.mark.parametrize("entry", [M3ViTServer, vit.M3ViT, vit.init_params,
                                   params_from_jax, ServingEngine,
                                   model.init_params, model.init_state])
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is usable")
    cfg = TM.SMOKE_CONFIG
    params = vit.init_params(0, cfg, device="cpu")
    for call in (lambda: M3ViTServer(cfg, params),
                 lambda: vit.M3ViT(cfg, params),
                 lambda: vit.init_params(0, cfg),
                 lambda: params_from_jax({"w": params["patch.b"].numpy()})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


_T = torch.zeros
# (op, operands the cuda kernel impl rejects, reason, impl used on the CPU)
REJECTED = {
    "linear": (("linear", _T(4, 8), _T(8, 4, dtype=torch.bfloat16)), {},
               "mixed dtypes", "eager"),
    "attention": (("attention", _T(1, 1, 4, 192), _T(1, 1, 4, 192),
                   _T(1, 1, 4, 192)), {}, "head_dim 192 > 128", "blocked"),
    "activation": (("activation", _T(4, 8)), {"kind": "relu"},
                   "no LUT correction table for 'relu'", "eager"),
    "moe_grouped_gemm": (("moe_grouped_gemm", _T(2, 3, 4), _T(2, 4, 5),
                          None), {}, "group_sizes unavailable", "eager"),
    "attention_decode": (("attention_decode", _T(2, 2, 1, 8), _T(2, 2, 6, 8),
                          _T(2, 2, 6, 8), torch.tensor([3, 5])), {},
                         "per-sequence cache lengths differ", "eager"),
}


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("op", list(REJECTED))
def test_kernel_impl_never_gives_way_to_a_plain_version_on_the_card(
        monkeypatch, op, on_card):
    """On the CPU a kernel impl's rejection moves down the candidate chain
    (recorded); with the operands on the card it raises instead."""
    from repro_torch import ops
    from repro_torch.ops import registry

    args, kwargs, reason, cpu_impl = REJECTED[op]
    ops.reset_dispatch_report()
    with ops.use_policy(ops.policy_named("cuda")):
        if on_card:
            # the operands' device is all the rule reads
            monkeypatch.setattr(registry, "_mode", lambda a: "cuda")
            with pytest.raises(ops.DispatchError, match=reason):
                ops.dispatch(*args, **kwargs)
            assert ops.dispatch_report() == {}
        else:
            ops.dispatch(*args, **kwargs)
            (fb,) = ops.dispatch_report()[op]["fallbacks"]
            assert fb["used"] == cpu_impl
            assert reason in fb["reasons"][0]


def _run_smoke(cwd):
    # no PYTHONPATH: the script must find the package next to itself
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
