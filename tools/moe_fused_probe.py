#!/usr/bin/env python3
"""Where the time of one ``moe_fused`` launch goes on the card, at M³ViT's
MoE layer (bf16, GELU through the LUT, 16 experts, top-4, capacity 68,
d 192, f 768).

    python3 tools/moe_fused_probe.py

Part ablations at 8 routing groups, each the device time of one wrapper
call (a CUDA graph of 10 calls replayed 20 times, ``chip_smoke.time_ms``),
beside the card's name and power limit: the CUDA source is copied (under
the git-ignored ``build/``), one part of the ``tc`` kernel is cut out (the
activation, the LUT lookup, the low half of the bf16 pair, the first
product, the scratch stores, ...), the copy is built with the flags of
``kernels/build.py`` and timed through the same wrapper.  A cut variant's
output is wrong by design and is not checked; the difference to ``base``
is what the part costs in the launch.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import routing as R  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
E, K, D, FF, C, T = 16, 4, 192, 768, 68, 128

# name -> [(file, pattern, replacement)], each pattern found at least once
CUTS = {
    "base": [],
    "no_activation": [("moe_fused.cu",
                       r"v\[e2\] = activate<KIND>\(\s*h\[i \+ e2\] \+ \(e2[^;]*;",
                       "v[e2] = h[i + e2];")],
    "relu_for_lut": [("common.cuh",
                      r"const float t = fabsf\(y\) \* scale;[^}]*",
                      "return fmaxf(y, 0.0f);\n")],
    "no_bias_loads": [("moe_fused.cu",
                       r"bias\[j\] = KIND == kGelu && f < F[^;]*;",
                       "bias[j] = make_float2(0.0f, 0.0f);")],
    "no_lo_products": [("moe_fused.cu",
                        r"sm90::wgmma_m64n64k16_rs\(\s*y\[a\], lo\[kk\],[^;]*;",
                        ";")],
    "no_first_product": [("moe_fused.cu",
                          r"sm90::wgmma_m64n64k16_ss_bt\(\s*h, xd,[^;]*;",
                          "h[0] += 0.0f;"),
                         ("moe_fused.cu", r"float h\[32\], u",
                          "float h[32] = {}, u")],
    "no_scratch_stores": [("moe_fused.cu",
                           r"\*reinterpret_cast<float4\*>\(\s*scratch \+[^;]*;",
                           "(void)gw;")],
}


def layer(g: int):
    """The wrapper's case for one M³ViT MoE layer at ``g`` routing
    groups."""
    r = R.route(cs.randn((g, T, E), torch.float32, seed=50), K, C)
    sizes = R.dispatch_counts(r, E)
    x = cs.randn((g, T, D), torch.bfloat16, seed=51)
    p = cs._fused_params("gelu", E, D, FF, torch.bfloat16, seed=52)
    return cs._moe_fused_case((x, p, r.expert, r.gate, r.position, r.valid,
                               sizes, "gelu", C, True, -8, 8.0))


def build_cuts(tmp: str) -> dict:
    nvcc = build._nvcc()
    procs = {}
    for name, cuts in CUTS.items():
        d = Path(tmp) / name
        d.mkdir()
        for src in CSRC.iterdir():
            if src.suffix == ".cuh" or src.name in ("errors.cu",
                                                    "moe_fused.cu"):
                (d / src.name).write_text(src.read_text())
        for fname, pat, rep in cuts:
            text, n = re.subn(pat, rep, (d / fname).read_text())
            if n == 0:
                raise AssertionError(f"{name}: {pat!r} not in {fname}")
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "moe_fused.cu"), str(d / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-2000:]}")
        libs[name] = ctypes.CDLL(str(Path(tmp) / name / "lib.so"))
    return libs


def ablations() -> dict:
    case = layer(8)
    real = build.function
    times: dict = {name: [] for name in CUTS}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = build_cuts(tmp)
        try:
            for _ in range(2):              # two rounds, in turn
                for name, lib in libs.items():
                    def function(fname, argtypes, _lib=lib):
                        fn = getattr(_lib, fname)
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                        return fn
                    build.function = function
                    times[name].append(cs.time_ms(case.kernel))
        finally:
            build.function = real
    base = min(times["base"])
    for name, ts in times.items():
        print(f"  {name}: {min(ts):.4f} ms (rounds {ts[0]:.4f}, "
              f"{ts[1]:.4f}); base - this {base - min(ts):+.4f} ms",
              flush=True)
    return {name: min(ts) for name, ts in times.items()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("moe_fused_probe: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    build.library()
    print("part ablations at G=8, ms per wrapper call:")
    parts = ablations()
    print(json.dumps({"card": smi, "ablations": parts}))


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
