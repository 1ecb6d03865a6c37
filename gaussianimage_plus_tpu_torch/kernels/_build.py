"""Build and load the hand-written CUDA kernels (plain C interface, ctypes).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library under ``build/torch_kernels/`` at the repository root (git
ignores it), named by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one loads at once. Nothing is built when a
module is imported: the first launch on a CUDA tensor builds, and
``build_all`` builds every kernel at once, one ``nvcc`` process per source,
all started together.

``-fmad=false`` keeps ``nvcc`` from contracting a separate multiply and add
into one fused multiply-add: the kernels write each ``fmaf`` they want
explicitly, in the order their plain PyTorch versions emulate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false"]

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    return "nvcc"


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{h}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    process (or None) and the library path."""
    src, so = _target(name)
    if so.exists():
        return None, so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), so


def _finish(name: str, started, so: Path) -> str:
    if started is None:
        return ""
    proc, tmp = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, so)
    return out


def build_all(names) -> dict:
    """Compile every named kernel concurrently; returns nvcc's output
    (``-Xptxas -v`` register and shared-memory report) per kernel."""
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs}
        return {n: _finish(n, *started[n]) for n in started}


def load(name: str, setup) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``setup(lib)`` declares
    the argtypes/restype of its C functions."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_target(name)[1]))
            setup(lib)
            _libs[name] = lib
        return _libs[name]


def launch(dev: torch.device, fn, *args) -> int:
    """Call a kernel's C entry point ``fn(*args, stream)`` on the current
    stream of CUDA device ``dev``, made the current device for the call when
    it is not; returns the entry point's ``cudaError_t``. It reads the raw
    stream handle: building a ``torch.cuda.Stream`` and switching devices on
    every call cost the host more than the kernels' three launches."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
