#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone on the card: the kernels' build,
then the four examples (``repro_torch.examples``) in-process, each
counted and checked as ``chip_smoke.py`` does, beside the card's name and
power limit.

    python3 tools/examples_probe.py
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("examples_probe: runs on an NVIDIA Hopper card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"CUDA {torch.version.cuda}")
    from repro_torch.kernels import build

    print(f"kernels built and loaded in {build.build_seconds():.1f} s")
    chip_smoke.examples_path()
