"""Builds the port's CUDA and host C++ sources at first use and loads them
with ctypes.

Each `ait_tpu_torch/csrc/<stem>.cu` compiles on its own, with nvcc, into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC [per-source flags] -o _build/<stem>-<hash>.so

Each host source `csrc/<stem>.cpp` (the batch loader and the COCO eval
loops, `ait_tpu_torch/native.py`) compiles with the host compiler:

    g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off
        -o _build/<stem>-<hash>.so

(no contraction into FMA, no -ffast-math, no -march=native: their float
arithmetic must round as numpy's does).  The library lands in
`ait_tpu_torch/_build/` under a name that carries the hash of the source,
the shared headers (`csrc/*.cuh`, for a CUDA source) and the flags, so an
edited source is rebuilt and a stale library is never loaded; it is written
under a temporary name and moved into place, so processes that build at
once each load a whole library.  `build_all` starts one compiler per source
at once and waits for all of them; a failed build raises with the
compiler's output.

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
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
              "-ffp-contract=off")

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


def host_compiler() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("no host C++ compiler (g++) found: the port's "
                           "host sources csrc/*.cpp are built with it")
    return found


def _is_host(stem: str) -> bool:
    return os.path.exists(os.path.join(CSRC, stem + ".cpp"))


def _flags(stem: str) -> List[str]:
    if _is_host(stem):
        return list(HOST_FLAGS)
    return list(BASE_FLAGS) + list(EXTRA_FLAGS.get(stem, ()))


def _sources(stem: str) -> List[str]:
    if _is_host(stem):
        return [stem + ".cpp"]
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [stem + ".cu"] + headers


def library_path(stem: str) -> str:
    h = hashlib.sha256()
    for name in _sources(stem):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags(stem)).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def _start(stem: str):
    """Start the compiler for one source; returns (popen, tmp path, final
    path), or None when the library for this exact source is already
    built."""
    out = library_path(stem)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    compiler = host_compiler() if _is_host(stem) else nvcc()
    cmd = [compiler] + _flags(stem) + [
        "-o", tmp, os.path.join(CSRC, _sources(stem)[0])]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} could not run for csrc/"
                           f"{_sources(stem)[0]}: {e}") from e
    return proc, tmp, out


def _finish(stem: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(proc.args[0])} failed for "
                           f"csrc/{_sources(stem)[0]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(stems: Iterable[str]) -> None:
    """Compile the given sources in parallel, one compiler each."""
    stems = list(stems)
    with _LOCK:
        started, errors = [], []
        for stem in stems:
            try:
                started.append((stem, _start(stem)))
            except RuntimeError as e:
                errors.append(str(e))
        for stem, st in started:
            try:
                _finish(stem, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(stem: str, functions: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu (or .cpp), built first if needed.

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
