"""``python -m repro_torch.launch.serve`` on the CPU (``--device cpu``, the
kernel modules' plain versions) at ``SMOKE_CONFIG``: the static engine,
the LM scheduler (greedy tokens equal to the static engine's), SLO tiers
with a bursty trace and the prefix cache, the M³ViT scheduler, packed
weights (``--quant``, ``--factor``) with the packed impls as dispatch hits,
and ``--mesh DxM``: a world of one in process, two gloo ranks under
``torchrun``, and a mesh that is not the world size refused."""

import os
import subprocess
import sys

import pytest

from repro_torch.launch import serve
from test_torch_threads import one_torch_thread  # noqa: F401


def _run(capsys, *argv):
    assert serve.main(["--device", "cpu", "--smoke", *argv]) == 0
    return capsys.readouterr().out


def test_static_generate(capsys):
    out = _run(capsys, "--arch", "llama3_2_1b", "--tokens", "6")
    assert "generated (4, 6) on cpu" in out


def test_lm_scheduler_reports_one_host_sync_a_step(capsys):
    out = _run(capsys, "--arch", "llama3_2_1b", "--scheduler", "--requests",
               "6", "--tokens", "8", "--dispatch-report")
    assert "scheduler served 6 requests" in out
    assert "1.00 host syncs a step" in out
    assert '"attention_decode": {"requests"' in out and "cuda_fused" in out


def test_lm_scheduler_slo_trace_prefix(capsys):
    out = _run(capsys, "--arch", "kimi_k2_1t_a32b", "--scheduler",
               "--requests", "8", "--slo", "--trace", "bursty",
               "--prefix-cache", "16", "--prefill-chunk", "16",
               "--max-len", "160")
    assert "scheduler served 8 requests" in out
    assert "slo: goodput" in out and "prefix cache:" in out


def test_vision_scheduler(capsys):
    out = _run(capsys, "--arch", "m3vit", "--scheduler", "--requests", "4",
               "--resident-fraction", "0.5", "--batch", "4")
    assert "scheduler served 4 semseg/depth requests on cpu" in out
    assert "resident_fraction 0.50" in out


@pytest.mark.parametrize("flag,item", [("--mesh", 6), ("--quant", 3),
                                       ("--factor", 3)])
def test_later_flags_raise(flag, item, capsys):
    """``--mesh`` (queue 1 item 6a, ported) serves at a mesh of one, with
    the collectives in the report, and refuses a mesh that is not the
    world size, naming both; ``--quant`` and ``--factor`` (item 3, ported)
    serve, their packed impls dispatch hits beside the kernels' plain
    versions."""
    if item != 3:
        with pytest.raises(ValueError, match="holds 2 ranks but the world "
                                             "size is 1"):
            serve.main(["--arch", "llama3_2_1b", "--smoke", "--device",
                        "cpu", flag, "1x2"])
        out = _run(capsys, "--arch", "llama3_2_1b", "--tokens", "4",
                   flag, "1x1", "--dispatch-report")
        assert "[serve] mesh 1x1 (data x model) over 1 rank(s), gloo" in out
        assert "generated (4, 4) on cpu" in out
        assert '"where": "engine tokens"' in out
        return
    from repro_torch import ops

    ops.reset_dispatch_report()
    if flag == "--quant":
        out = _run(capsys, "--arch", "llama3_2_1b", "--tokens", "4",
                   "--quant", "int8", "--dispatch-report")
        hits = ('"attention_decode": {"requests": 8, "hits": '
                '{"eager_int8": 8}, "fallbacks": []',
                '"linear": {"requests": 70, "hits": {"eager_int8": 70}, '
                '"fallbacks": []')
    else:
        out = _run(capsys, "--arch", "m3vit", "--scheduler", "--requests",
                   "2", "--batch", "2", "--factor", "butterfly",
                   "--dispatch-report")
        hits = ('"moe_grouped_gemm": {"requests": 16, "hits": '
                '{"eager_factored": 16}, "fallbacks": []',
                '"linear": {"requests": 44, "hits": {"cuda": 44}, '
                '"fallbacks": []')
    for h in hits:
        assert h in out, out


def test_defaults_to_the_card():
    """No --device: the card, which this machine lacks — a loud error, no
    fallback to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "llama3_2_1b", "--smoke"])


def test_mesh_serves_under_torchrun(tmp_path):
    """Two gloo ranks under ``torchrun --standalone``: M³ViT's experts page
    expert-parallel over a 1x2 mesh; rank 0 reports the shard load."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--arch", "m3vit", "--smoke", "--device", "cpu", "--scheduler",
         "--requests", "4", "--batch", "2", "--mesh", "1x2"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("[serve] mesh 1x2 (data x model) over 2 rank(s), "
                          "gloo") == 1
    assert "[serve] shard load [" in r.stdout
    assert "scheduler served 4 semseg/depth requests on cpu" in r.stdout
