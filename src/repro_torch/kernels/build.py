"""Build and load the CUDA kernel libraries.

Every ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with
``ctypes``. The libraries are built at first use into
``build/repro_torch_kernels/`` at the root of the checkout, named by a
hash of their source so that an edited source is rebuilt. All missing
libraries are compiled at once, one ``nvcc`` process per source.

Nothing here runs at import time: the CPU tests import every module on
a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

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


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
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


def bump(namespace: dict, counter: str) -> None:
    """Add one to the launch counter ``counter`` of a kernel module
    (``namespace`` is its ``globals()``). The distributed path launches
    from one thread per site, so the add holds a lock."""
    with _COUNT_LOCK:
        namespace[counter] += 1


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_handle(device: Optional[object] = None) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
