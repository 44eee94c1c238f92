"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each `ait_tpu_torch/csrc/<stem>.cu` compiles on its own, with nvcc, into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC [per-source flags] -o _build/<stem>-<hash>.so

The library lands in `ait_tpu_torch/_build/` under a name that carries the
hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source is rebuilt and a stale library is never loaded.  `build_all`
starts one nvcc per source at once and waits for all of them.

Every C entry point takes its pointers and the CUDA stream as `void*`,
launches on that stream, and returns `cudaGetLastError()`; `check` turns a
non-zero code into an exception.  Nothing here is imported by a module at
import time: the first wrapper call on a CUDA tensor builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# the NMS predicate must round every multiply and add on its own, exactly as
# the JAX package's XLA and Mosaic versions do: no contraction into FMA
EXTRA_FLAGS: Dict[str, Sequence[str]] = {"nms": ("--fmad=false",)}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on the machine with the GPU")
    return path


def _flags(stem: str) -> List[str]:
    return list(BASE_FLAGS) + list(EXTRA_FLAGS.get(stem, ()))


def library_path(stem: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [stem + ".cu"] + headers:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags(stem)).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def _start(stem: str):
    """Start nvcc for one source; returns (popen, tmp path, final path), or
    None when the library for this exact source is already built."""
    out = library_path(stem)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc()] + _flags(stem) + ["-o", tmp,
                                     os.path.join(CSRC, stem + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(stem: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{stem}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(stems: Iterable[str]) -> None:
    """Compile the given sources in parallel, one nvcc each."""
    stems = list(stems)
    with _LOCK:
        started = [(s, _start(s)) for s in stems]
        errors = []
        for stem, st in started:
            try:
                _finish(stem, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(stem: str, functions: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu, built first if needed.

    functions: C entry name -> ctypes argtypes; each returns an int
    (cudaError_t)."""
    lib = _LIBS.get(stem)
    if lib is not None:
        return lib
    build_all([stem])
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(library_path(stem))
            for name, argtypes in functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIBS[stem] = lib
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_operands(name: str, device, tensors) -> None:
    """Contiguous, on `device`, and 16-byte aligned (the kernels read and
    write 16-byte vectors)."""
    for t in tensors:
        require(t.device == device and t.is_contiguous() and
                t.data_ptr() % 16 == 0,
                f"{name}: operands must be contiguous, 16-byte aligned, on "
                "one CUDA device")
