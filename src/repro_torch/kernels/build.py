"""Build and load the port's CUDA kernels (takes the place of the reference's
``kernels/runtime.py``, which chose a Pallas execution mode).

At first use every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) with
``nvcc``, one process per source, all started together, and the objects
are linked into one shared library under ``build/`` at the repository
root.  The file name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library.  It is loaded with
``ctypes``; each kernel module declares its C function's argument types
through :func:`function`.

Nothing here runs at import: the CPU tests import every module.  A build is
refused, with the reason, when CUDA is absent, the card is not compute
capability 9.0, or ``nvcc`` fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["library", "function", "check", "tickets", "build_seconds",
           "build_log", "sass_counts", "DTYPE_CODES", "NVCC_FLAGS",
           "PLAIN_DEVICES"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: dtype codes of csrc/common.cuh:DTypeCode
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: devices on which a kernel wrapper runs its plain version: the CPU (the
#: tests) and ``meta`` (the shape-only dry-run, where nothing is computed)
PLAIN_DEVICES = ("cpu", "meta")

_LOCK = threading.Lock()
_STATE: dict = {}
_TICKETS: dict = {}          # (kernel, device index) -> int32 counters


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME): the "
                       "CUDA kernels cannot be built")


def _check_device() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the kernels run only on "
                           "an NVIDIA Hopper card (pass CPU tensors to run "
                           "the plain versions)")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); "
                           f"this card is compute capability {cap}")


def _source_key() -> str:
    """Hash of every source and header under csrc/ and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: list[Path], out: Path) -> None:
    """Compile each source in its own nvcc process (all in parallel), then
    link the objects into ``out``; the compilers' messages (``-Xptxas=-v``:
    registers, shared memory and spills per kernel) go beside it as
    ``.log``, written before the library appears."""
    # per-process scratch: two processes building at once never share files
    objdir = out.parent / f"{out.stem}.objs{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = objdir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out.parent / f"{out.stem}.tmp{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    out.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _LOCK:
        if "lib" in _STATE:
            return _STATE["lib"]
        _check_device()
        sources = sorted(_CSRC.glob("*.cu"))
        if not sources:
            raise RuntimeError(f"no CUDA sources under {_CSRC}")
        so = _BUILD / f"librepro_torch_{_source_key()}.so"
        t0 = time.perf_counter()
        if not so.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            _compile(_nvcc(), sources, so)
        _STATE["lib"] = ctypes.CDLL(str(so))
        _STATE["seconds"] = time.perf_counter() - t0
        _STATE["path"] = so
        return _STATE["lib"]


def build_seconds() -> float:
    """Seconds the first :func:`library` call took (build + load)."""
    library()
    return _STATE["seconds"]


def build_log() -> str:
    """The compilers' messages from the build of the loaded library."""
    library()
    log = _STATE["path"].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass_counts(opcode: str) -> dict[str, int]:
    """How many times each kernel of the loaded library issues ``opcode``
    in its SASS (``cuobjdump -sass``, from the toolkit beside ``nvcc``):
    mangled kernel name -> count, kernels without it left out."""
    library()
    tool = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(_STATE["path"])],
                          capture_output=True, text=True, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
        elif name is not None and opcode in line:
            counts[name] = counts.get(name, 0) + 1
    return counts


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point ``name`` with its argument types declared (pointers and
    the stream as ``c_void_p``, so ctypes never truncates them to 32 bits);
    every entry point returns ``cudaGetLastError()`` as an int."""
    fns = _STATE.setdefault("fns", {})
    if name not in fns:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns[name]


def check(name: str, err: int) -> None:
    """Raise if a launch reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = getattr(library(), "kernel_error_string")
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{msg(err).decode()}")


def tickets(kernel: str, device, n: int) -> torch.Tensor:
    """The arrival counters of ``kernel``'s launches on ``device`` whose
    last block of a group combines the group's float32 partials (split-K
    tiles, decode splits): zeros, allocated once per kernel and device
    (outside any CUDA graph capture) and left at zero by every launch,
    whose last block of a group resets its counter.  Such launches of one
    kernel on one device therefore run in stream order, never concurrently
    on two streams."""
    t = _TICKETS.get((kernel, device.index))
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{kernel}: its tickets must be allocated "
                               f"before a CUDA graph capture; launch the "
                               f"shape once outside it")
        t = torch.zeros(max(n, 1 << 16), dtype=torch.int32, device=device)
        _TICKETS[(kernel, device.index)] = t
    return t
