"""Multi-pod dry-run: every (architecture x input shape) cell on the
production meshes, with NO allocation (tensors on the ``meta`` device).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek_67b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out build/dryrun

PyTorch twin of ``repro.launch.dryrun``, in one process. The reference
lowers and compiles each cell for 256 or 512 chips and reads XLA's memory
and cost analyses and the partitioned HLO (``launch/hlo_analysis.py``).
No torch program here is partitioned or compiled to HLO, so the port
keeps that parser for parity and counts in its place. Per cell it
records to ``<out>/dryrun_<arch>_<shape>_<mesh>.json``:

  * ``params_total``, ``params_active``, ``tokens``, ``model_flops``
    (6 N D for train, 2 N D otherwise) and ``param_bytes_total``, as the
    reference computes them;
  * per-device parameter, optimizer and input bytes under the mesh's
    shardings: each leaf's dims divided by the sizes of the mesh axes
    its spec names;
  * ``counted_flops``: ``torch.utils.flop_counter.FlopCounterMode`` over
    the cell's step run on meta (the train step with its backward, a
    prefill, or one decode step over the cell's caches), for the whole
    global batch;
  * ``hbm_bytes_proxy``: twice the bytes of every aten op's result (views
    excluded), the reference's HLO proxy applied to eager ops;
  * ``collectives: null``: one process runs no partitioned program (the
    real count waits for a multi-GPU mesh, ROADMAP queue 1 item 9).

The meta device takes the kernels' plain versions, and a recurrence runs
its first step there, counted by its trip count (``kernels.ops.
meta_trips``), as the reference's analysis scales a rolled loop. So the
counts compare with a run of the plain versions, not with the card's
kernels: a ctypes launch is no aten op, and ``FlopCounterMode`` does not
see it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from .. import tree as TR
from ..configs import SHAPES, cells, get_config
from ..kernels import ops as kops
from ..models import sharding as SH
from ..models import transformer as T
from ..models.config import LayerKind, ModelConfig
from ..train import optim as O
from ..train.train_loop import (decode_step_fn, prefill_step_fn,
                                train_step_fn)
from .mesh import abstract_production_mesh

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "../../..", "build",
    "dryrun"))


# ---------------------------------------------------------------------------
# input specs (shape, dtype and sharding stand-ins)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeDtypeStruct:
    """``jax.ShapeDtypeStruct``: a shape, a dtype and a sharding."""
    shape: tuple
    dtype: torch.dtype
    sharding: Optional[SH.NamedSharding] = None

    def meta(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def _sds(shape, dtype, *axes):
    return ShapeDtypeStruct(tuple(shape), dtype, SH.named_sharding(*axes))


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """Stand-ins for every model input of the given benchmark shape."""
    sh = SHAPES[shape_name]
    S, B, step = sh["seq_len"], sh["global_batch"], sh["step"]
    bf16, i32 = torch.bfloat16, torch.int32
    if step == "train":
        batch = {
            "tokens": _sds((B, S), i32, "dp", None),
            "labels": _sds((B, S), i32, "dp", None),
        }
        if cfg.n_image_tokens:
            batch["embeds_prefix"] = _sds(
                (B, cfg.n_image_tokens, cfg.d_model), bf16, "dp", None, None)
        if cfg.enc_layers:
            batch["enc_embeds"] = _sds((B, S, cfg.d_model), bf16,
                                       "dp", None, None)
        return {"batch": batch}
    if step == "prefill":
        batch = {"tokens": _sds((B, S), i32, "dp", None)}
        if cfg.enc_layers:
            batch["enc_embeds"] = _sds((B, S, cfg.d_model), bf16,
                                       "dp", None, None)
        if cfg.n_image_tokens:
            batch["embeds_prefix"] = _sds(
                (B, cfg.n_image_tokens, cfg.d_model), bf16, "dp", None, None)
        return {"batch": batch}
    assert step == "decode"
    long_ctx = B == 1      # long_500k: shard the sequence, not the batch
    bd = None if long_ctx else "dp"
    sq = "sp" if long_ctx else None
    caches = {}
    nb = cfg.n_blocks
    dt = bf16
    # KV caches: batch over dp; head_dim over model; long-context shards
    # seq over data (the reference's layout)
    hd_ax = "model" if cfg.hd % 16 == 0 else None
    for pos in range(cfg.period):
        kind = cfg.layer_kind(pos)
        if kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
            kv_shape = (nb, B, cfg.n_kv_heads, S, cfg.hd)
            caches[str(pos)] = {
                "kv_k": _sds(kv_shape, dt, None, bd, None, sq, hd_ax),
                "kv_v": _sds(kv_shape, dt, None, bd, None, sq, hd_ax),
            }
        elif kind == LayerKind.MAMBA:
            din = cfg.mamba_expand * cfg.d_model
            caches[str(pos)] = {
                "conv": _sds((nb, B, cfg.mamba_conv - 1, din), dt,
                             None, bd, None, "model"),
                "ssm": _sds((nb, B, din, cfg.mamba_d_state), torch.float32,
                            None, bd, "model", None),
            }
        elif kind == LayerKind.RWKV:
            H = cfg.d_model // cfg.rwkv_head_dim
            K = cfg.rwkv_head_dim
            caches[str(pos)] = {
                "shift": _sds((nb, B, 1, cfg.d_model), dt,
                              None, bd, None, None),
                "wkv": _sds((nb, B, H, K, K), torch.float32,
                            None, bd, "model", None, None),
            }
    batch = {
        "token": _sds((B,), i32, bd),
        "cache_len": ShapeDtypeStruct((), i32),
    }
    if cfg.enc_layers:
        batch["enc_out"] = _sds((B, S, cfg.d_model), dt, bd, None, None)
    return {"caches": caches, "batch": batch}


def opt_shardings(ocfg: O.OptConfig, cfg: ModelConfig, fsdp: bool = False):
    """Optimizer-state shardings derived from the parameter defs.
    Under FSDP they inherit the data-sharded axes (ZeRO for free)."""
    defs = T.param_defs(cfg, fsdp=fsdp)

    def leaf(_, pd: T.PD):
        return SH.named_sharding(*pd.axes)

    def fact(_, pd: T.PD):
        if len(pd.shape) >= 2:
            return {"vr": SH.named_sharding(*pd.axes[:-1]),
                    "vc": SH.named_sharding(*(pd.axes[:-2] + pd.axes[-1:]))}
        return {"v": SH.named_sharding(*pd.axes)}

    if ocfg.kind == "adamw":
        return {"step": SH.named_sharding(),
                "m": T._leaf_map(leaf, defs), "v": T._leaf_map(leaf, defs)}
    return {"step": SH.named_sharding(), "f": T._leaf_map(fact, defs)}


USE_FSDP_TRAIN = True   # FSDP weight sharding for train, as the reference


def abstract_opt_state(ocfg: O.OptConfig, cfg: ModelConfig,
                       shardings) -> Dict:
    ab = O.abstract_state(ocfg, T.abstract_params(cfg))
    return TR.tree_map(
        lambda x, s: ShapeDtypeStruct(tuple(x.shape), x.dtype, s),
        ab, shardings)


# ---------------------------------------------------------------------------
# HLO collective parsing (the reference's, kept for parity: no torch
# program here produces HLO)
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "c64": 8, "c128": 16, "f8e4m3fn": 1,
                "f8e5m2": 1}

_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|u8|"
                       r"pred|c64|c128|f8e4m3fn|f8e5m2)\[([0-9,]*)\]")

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")


def _shape_bytes(text: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(text):
        dt, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum result bytes of every collective op in post-SPMD HLO."""
    out = {k: 0 for k in _COLL_OPS}
    out["count"] = 0
    for line in hlo_text.splitlines():
        stripped = line.strip()
        for op in _COLL_OPS:
            # match "= shape op(" — result type precedes the op name
            idx = stripped.find(f" {op}(")
            if idx == -1:
                idx = stripped.find(f" {op}-start(")
            if idx == -1:
                continue
            eq = stripped.find("=")
            if eq == -1 or "-done(" in stripped:
                continue
            result_type = stripped[eq + 1:idx]
            out[op] += _shape_bytes(result_type)
            out["count"] += 1
            break
    return out


# ---------------------------------------------------------------------------
# counting a step on meta
# ---------------------------------------------------------------------------

class _ResultBytes(TorchDispatchMode):
    """The bytes of every aten op's tensor results; views (which move
    nothing) are left out, in-place results counted."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns):
            self.total += sum(t.numel() * t.element_size()
                              for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
        return out


class Tally:
    """``FlopCounterMode``'s flops and the result bytes of every aten op
    over a region, each op inside ``kops.meta_trips(n)`` counted n
    times."""

    def __enter__(self) -> "Tally":
        self._flops = FlopCounterMode(display=False)
        self._bytes = _ResultBytes()
        self._extra = 0
        self._flops.__enter__()
        self._bytes.__enter__()
        kops.TRIP_COUNTERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        kops.TRIP_COUNTERS.remove(self)
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)

    @property
    def flops(self) -> int:
        return self._flops.get_total_flops() + self._extra

    @property
    def result_bytes(self) -> int:
        return self._bytes.total

    def mark(self) -> tuple:
        return self.flops, self.result_bytes

    def repeat(self, mark: tuple, times: int) -> None:
        flops, nbytes = self.mark()
        self._extra += times * (flops - mark[0])
        self._bytes.total += times * (nbytes - mark[1])


def count_step(run) -> Dict[str, float]:
    """``counted_flops`` and ``hbm_bytes_proxy`` of ``run()``."""
    with Tally() as t:
        run()
    return {"counted_flops": float(t.flops),
            "hbm_bytes_proxy": 2.0 * t.result_bytes}


def _meta(tree):
    return TR.tree_map(lambda s: s.meta(), tree)


def step_runner(cfg: ModelConfig, shape_name: str, params, specs: Dict,
                ocfg: Optional[O.OptConfig] = None):
    """The cell's step as a thunk over ``params`` (meta or real) and
    stand-ins for its inputs: the train step with ``ocfg``'s optimizer,
    a prefill, or one decode step at the caches' last slot (so that it
    attends over the whole cache, as the reference's compiled step
    does)."""
    step = SHAPES[shape_name]["step"]
    if step == "train":
        fn = train_step_fn(cfg, ocfg)[0]
        opt = O.abstract_state(ocfg, params) \
            if TR.leaves(params)[0].device.type == "meta" \
            else O.init_state(ocfg, params)
        batch = _materialize(specs["batch"], params)
        return lambda: fn(params, opt, batch)
    if step == "prefill":
        fn = prefill_step_fn(cfg)
        batch = _materialize(specs["batch"], params)
        return lambda: fn(params, batch)
    fn = decode_step_fn(cfg)
    caches = _materialize(specs["caches"], params)
    batch = dict(specs["batch"])
    cache_len = SHAPES[shape_name]["seq_len"] - 1
    del batch["cache_len"]
    batch = _materialize(batch, params)
    batch["cache_len"] = cache_len
    return lambda: fn(params, caches, batch)


def _materialize(specs, params):
    """Tensors for ``specs`` on the parameters' device: empty on meta,
    zeros elsewhere (token 0 and the caches' start)."""
    dev = TR.leaves(params)[0].device
    if dev.type == "meta":
        return _meta(specs)
    return TR.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                             device=dev), specs)


# ---------------------------------------------------------------------------
# per-cell dry run
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape_name: str) -> Dict[str, float]:
    sh = SHAPES[shape_name]
    S, B, step = sh["seq_len"], sh["global_batch"], sh["step"]
    abs_p = T.abstract_params(cfg)
    n_total = sum(x.numel() for x in TR.leaves(abs_p))
    # active params: subtract non-routed experts
    n_active = n_total
    if cfg.moe is not None:
        m = cfg.moe
        n_moe = sum(1 for i in range(cfg.n_layers) if cfg.has_moe_at(i))
        mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        n_active -= n_moe * (m.num_experts - m.top_k) * mult \
            * cfg.d_model * m.d_ff_expert
    tokens = B * S if step in ("train", "prefill") else B
    factor = 6 if step == "train" else 2
    return {"params_total": float(n_total),
            "params_active": float(n_active),
            "tokens": float(tokens),
            "model_flops": float(factor) * float(n_active) * float(tokens)}


def per_device_bytes(tree) -> int:
    """Bytes a device holds of a tree of ``ShapeDtypeStruct``s: each
    leaf's shard shape times its itemsize."""
    total = 0
    for s in TR.leaves(tree):
        shape = s.sharding.shard_shape(s.shape) if s.sharding else s.shape
        n = 1
        for d in shape:
            n *= d
        total += n * s.dtype.itemsize
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = None, verbose: bool = True) -> Optional[dict]:
    mesh = abstract_production_mesh(multi_pod)
    prev = SH.current_mesh()
    SH.set_mesh(mesh)
    try:
        record = _cell(arch, shape_name, multi_pod, mesh)
    finally:
        SH.set_mesh(prev)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"dryrun_{arch}_{shape_name}_{record['mesh']}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(record, f, indent=1)
    if verbose:
        print(f"[{record['mesh']}] {arch} x {shape_name}: counted "
              f"{record['counted_flops']:.4g} flops "
              f"({record['counted_flops'] / record['model_flops']:.3f} x "
              f"model_flops {record['model_flops']:.4g}), hbm proxy "
              f"{record['hbm_bytes_proxy'] / 2 ** 30:.1f} GiB; per device: "
              f"params {record['param_bytes_per_device'] / 2 ** 30:.2f} GiB,"
              f" optimizer {record['opt_bytes_per_device'] / 2 ** 30:.2f} "
              f"GiB, inputs {record['input_bytes_per_device'] / 2 ** 30:.2f}"
              f" GiB; counted in {record['count_s']:.1f} s", flush=True)
    return record


def cell_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """The cell's stand-ins under the mesh that is set: "params" (with
    the FSDP rule of a train cell), "inputs" and, for a train cell, "opt"
    (the optimizer ``train_step_fn`` picks, under "ocfg")."""
    fsdp = USE_FSDP_TRAIN and SHAPES[shape_name]["step"] == "train"
    out = {"params": TR.tree_map(
        lambda x, s: ShapeDtypeStruct(tuple(x.shape), x.dtype, s),
        T.abstract_params(cfg), T.param_shardings(cfg, fsdp=fsdp)),
        "inputs": input_specs(cfg, shape_name)}
    if SHAPES[shape_name]["step"] == "train":
        ocfg = train_step_fn(cfg)[1]
        out["ocfg"] = ocfg
        out["opt"] = abstract_opt_state(ocfg, cfg,
                                        opt_shardings(ocfg, cfg, fsdp=fsdp))
    return out


def _cell(arch: str, shape_name: str, multi_pod: bool, mesh) -> dict:
    cfg = get_config(arch)
    step = SHAPES[shape_name]["step"]
    record = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16",
              "chips": mesh.size, "step": step,
              "fsdp": USE_FSDP_TRAIN and step == "train"}
    specs = cell_specs(cfg, shape_name)
    ocfg = specs.get("ocfg")
    if ocfg is not None:
        record["optimizer"] = ocfg.kind
    record["param_bytes_per_device"] = per_device_bytes(specs["params"])
    record["opt_bytes_per_device"] = per_device_bytes(specs.get("opt", {}))
    record["input_bytes_per_device"] = per_device_bytes(specs["inputs"])
    params = _meta(specs["params"])
    t0 = time.time()
    record.update(count_step(step_runner(cfg, shape_name, params,
                                         specs["inputs"], ocfg)))
    record["count_s"] = round(time.time() - t0, 2)
    record["collectives"] = None
    record["collectives_note"] = (
        "one process runs no partitioned program: the collectives come "
        "with a multi-GPU mesh (ROADMAP queue 1 item 9)")
    record.update(model_flops(cfg, shape_name))
    # parameter memory tally (whole model)
    record["param_bytes_total"] = sum(
        x.numel() * x.element_size() for x in TR.leaves(params))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out = args.out or RESULTS_DIR
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    if args.all:
        todo = [(a, s, skip) for a, s, skip in cells()]
    else:
        assert args.arch and args.shape
        todo = [(args.arch, args.shape, None)]

    failures = []
    for arch, shape_name, skip in todo:
        if skip:
            print(f"SKIP {arch} x {shape_name}: {skip}")
            continue
        for mp in meshes:
            try:
                run_cell(arch, shape_name, mp, out_dir=out)
            except Exception as e:
                import traceback
                traceback.print_exc()
                failures.append((arch, shape_name, mp, str(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
