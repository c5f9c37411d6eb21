"""Build and load the CUDA kernel libraries.

Every ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with
``ctypes``. The libraries are built at first use into
``build/repro_torch_kernels/`` at the root of the checkout, named by a
hash of their source and of the headers it includes from ``csrc/``
(its ``#include "..."`` lines, followed into those headers) so that an
edited source or header rebuilds the libraries that use it and no other. All missing libraries are
compiled at once, one ``nvcc`` process per source.

Nothing here runs at import time: the CPU tests import every module on
a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _local_headers(src: bytes, seen: Optional[list] = None) -> list:
    """The ``csrc/`` headers that ``src`` includes with quotes, each once,
    in the order first met, with the headers they include in turn."""
    seen = [] if seen is None else seen
    for m in _INCLUDE.finditer(src):
        name = m.group(1).decode()
        path = CSRC / name
        if name not in seen and path.exists():
            seen.append(name)
            _local_headers(path.read_bytes(), seen)
    return seen


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join((CSRC / h).read_bytes() for h in _local_headers(src))
    digest = hashlib.sha1(src + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    returns {name: library path}. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in sources()}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        if verbose and out:
            print(f"[nvcc {name}.cu]\n{out}", flush=True)
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _LIBS[name] = lib
        return lib


def batch_stride(what: str, t: torch.Tensor, dims: int, B: int) -> int:
    """The batch stride, in elements, of an operand of a batched launch
    (B calls in one): 0 where ``t`` has one call's ``dims`` dims (shared
    by the B calls, read in place), a slice's size where it has a
    leading axis of B. Raises for a B outside [1, 65535] (the kernels'
    grid axis)."""
    if isinstance(B, bool) or not 1 <= B <= 65535:
        raise ValueError(f"{what}: batch of {B}, want 1 to 65535")
    if t.dim() == dims:
        return 0
    if t.dim() == dims + 1 and t.shape[0] == B:
        return t[0].numel()
    raise ValueError(f"{what}: want {dims} dims, or {dims + 1} with a "
                     f"leading batch of {B}; got {tuple(t.shape)}")


def launch(fn, index: int, args: tuple, what: str, counts: dict,
           counter: str, batched: Optional[str] = None) -> None:
    """Call the C entry point ``fn(*args, stream)`` on CUDA device
    ``index`` and count the launch: every wrapper launches through here.

    ``stream`` is the device's current stream as a raw handle, read on
    every call, so that a caller's ``torch.cuda.stream(s)`` is honoured.
    The current device is switched to ``index`` only where it differs,
    and back after. A nonzero return (the entry point's
    ``cudaGetLastError()``) raises; else ``counts[counter]`` (a kernel
    module's ``globals()`` or a dict of counts) gains one, under a lock,
    since the distributed path launches from one thread per site, and
    so does ``counts[batched]`` where the launch ran a batch of calls."""
    C = torch._C
    prev = C._cuda_getDevice()
    if prev == index:
        err = fn(*args, C._cuda_getCurrentRawStream(index))
    else:
        C._cuda_setDevice(index)
        try:
            err = fn(*args, C._cuda_getCurrentRawStream(index))
        finally:
            C._cuda_setDevice(prev)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
    with _COUNT_LOCK:
        counts[counter] += 1
        if batched is not None:
            counts[batched] += 1
