"""Fault-tolerant checkpointing.

PyTorch twin of ``repro.train.checkpoint``. Layout:

    <dir>/step_<N>/
        manifest.json      step, leaf paths, shapes, dtypes, hashes, extra
        arrays.npz         one entry per tree leaf ("a/b/c" paths)
        .complete          written LAST (the atomic commit marker)

Leaves are numpy arrays on disk: bf16 tensors as their uint16 bits, with
"bfloat16" in the manifest, so that each leaf's sha256 is that of its
bytes, as the reference hashes them. A checkpoint without ``.complete``
is ignored; ``restore`` verifies every hash; ``keep_last_k`` are kept;
``AsyncCheckpointer`` copies to the host, then writes in a thread.
``restore`` puts each leaf on the device its template leaf (or
``shardings``, a tree of devices) names: a run may resume on another
device than it saved from.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import tree as TR


def _flatten_with_paths(tree) -> Dict[str, Any]:
    return dict(TR.flatten(tree))


def _to_host(t) -> np.ndarray:
    """A leaf's bytes as a numpy array (bf16 as uint16 bits)."""
    if torch.is_tensor(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


def _dtype_name(t) -> str:
    if torch.is_tensor(t):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def save(directory: str, step: int, tree, extra: Optional[dict] = None,
         keep_last_k: int = 3) -> str:
    """Synchronous atomic save. Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = _flatten_with_paths(tree)
    host = {k: _to_host(v) for k, v in leaves.items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(host[k].shape),
                       "dtype": _dtype_name(v),
                       "sha256_16": hashlib.sha256(
                           host[k].tobytes()).hexdigest()[:16]}
                   for k, v in leaves.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    with open(os.path.join(tmp, ".complete"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(directory, keep_last_k)
    return final


def _retain(directory: str, k: int):
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in ckpts[:-k] if k > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    best = None
    for d in sorted(os.listdir(directory)):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, ".complete")):
                best = int(d[len("step_"):])
    return best


def restore(directory: str, step: Optional[int] = None,
            template=None, shardings=None,
            verify: bool = True) -> Tuple[Any, dict]:
    """Load a checkpoint (the latest complete one by default). Without a
    ``template``, returns the flat {path: CPU tensor} dict; with one (a
    tree of the same structure, values ignored), that tree, each leaf on
    its template leaf's device, or on the device ``shardings`` (a tree
    of devices, None for the template's) names for it."""
    if step is None:
        step = latest_step(directory)
        assert step is not None, f"no complete checkpoint in {directory}"
    path = os.path.join(directory, f"step_{step:08d}")
    assert os.path.exists(os.path.join(path, ".complete")), (
        f"checkpoint {path} incomplete")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    if verify:
        for k, v in arrays.items():
            h = hashlib.sha256(v.tobytes()).hexdigest()[:16]
            exp = manifest["leaves"][k]["sha256_16"]
            assert h == exp, f"checksum mismatch for {k}"
    tensors = {k: _from_host(v, manifest["leaves"][k]["dtype"])
               for k, v in arrays.items()}
    if template is None:
        return tensors, manifest
    flat = TR.flatten(template)
    devs = (TR.leaves(shardings) if shardings is not None
            else [None] * len(flat))
    ordered = []
    for (k, leaf), dev in zip(flat, devs):
        if dev is None and torch.is_tensor(leaf):
            dev = leaf.device
        ordered.append(tensors[k].to(dev) if dev is not None
                       else tensors[k])
    return TR.unflatten_like(template, ordered), manifest


class AsyncCheckpointer:
    """Background-thread checkpointing: ``save`` returns right after the
    copy to the host; the previous write is joined first (at most one
    outstanding write, bounding disk and host memory)."""

    def __init__(self, directory: str, keep_last_k: int = 3):
        self.directory = directory
        self.keep = keep_last_k
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree, extra: Optional[dict] = None):
        self.wait()
        # device -> host, blocking; a copy even on the CPU, since a
        # donating train step updates the tensors in place
        host = TR.tree_map(lambda t: t.detach().to("cpu", copy=True)
                           if torch.is_tensor(t) else t, tree)

        def work():
            self.last_path = save(self.directory, step, host, extra,
                                  self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
