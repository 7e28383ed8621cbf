"""Build the port's CUDA kernels from the package's own sources and bind them.

Each ``csrc/<name>.cu`` (plus the shared ``csrc/*.cuh`` headers) compiles
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded through ``ctypes``. Libraries land in ``build/repro_torch/`` beside
``src/``, named by a hash of the sources and flags, so an edit rebuilds and
an unchanged tree reuses the earlier build. Nothing is built at import: the
first launch builds what it needs, and :func:`build` builds several sources
at once with one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> (C symbol, argtypes); every symbol returns cudaGetLastError()
SIGNATURES = {
    "sumtree_update": ("sumtree_update_launch", [_P, _I, _P, _P, _I, _P, _P]),
    "sumtree_sample": ("sumtree_sample_launch", [_P, _I, _P, _I, _P, _P, _P]),
    "replay_ingest": ("replay_ingest_launch",
                      [_P, _I, _P, _P, _P, _I, _F, _I, _P, _P, _P, _P, _P]),
}

_fns: dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every named source not yet built, in parallel; return each
    new build's compiler output (``-Xptxas -v``: registers, shared memory,
    spills). Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(logs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def launcher(name: str):
    """The bound C launch function of kernel ``name``, built on first use."""
    with _lock:
        if name not in _fns:
            build((name,))
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _fns[name] = fn
        return _fns[name]


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the C side takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 device: torch.device, shape: tuple | None = None) -> None:
    """Validate what a kernel takes before its pointer is passed."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
