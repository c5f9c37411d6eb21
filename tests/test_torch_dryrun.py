"""The port's dry-run against the reference on the CPU: ``model_flops``
and ``param_bytes_total`` for every cell of ``configs.cells()``, the
per-device parameter, optimizer and input bytes of every unskipped cell
on both production meshes (from the reference's shard shapes, computed
in a child process with 512 host devices, ``_torch_dryrun_ref.py``),
``collective_bytes`` and ``hlo_analysis`` on HLO text the reference
compiles, and the counts themselves: ``counted_flops`` of a meta run
equal to the same step's on the CPU with real tensors (one train, one
prefill and one decode cell at smoke size), and whole records of one
cell of each step kind at full size on meta."""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.launch import hlo_analysis as RHA
from repro_torch import configs as TC
from repro_torch import tree as TR
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as THA
from repro_torch.launch import mesh as TMESH
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as TT

import _torch_dryrun_ref

CELLS = RC.cells()
RUN = [(a, s) for a, s, skip in CELLS if skip is None]


@pytest.fixture(scope="module")
def ref_cells():
    return _torch_dryrun_ref.reference("cells")


@pytest.fixture(scope="module")
def ref_shards():
    return _torch_dryrun_ref.reference("shards")


def test_cells_match_reference():
    assert TC.cells() == CELLS and TC.SHAPES == RC.SHAPES
    assert len(RUN) == 33


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in CELLS])
def test_model_flops_and_param_bytes_match_reference(ref_cells, arch,
                                                     shape):
    want = ref_cells[f"cell/{arch}/{shape}"]
    cfg = TC.get_config(arch)
    got = D.model_flops(cfg, shape)
    got["param_bytes_total"] = sum(
        x.numel() * x.element_size() for x in TR.leaves(
            TT.abstract_params(cfg)))
    assert got == want


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch,shape", RUN)
def test_per_device_bytes_match_reference_shards(ref_shards, arch, shape,
                                                 multi_pod):
    """Each tally is the sum over leaves of the reference's shard shape
    times the leaf's itemsize; the leaves' shard shapes themselves are
    the reference's."""
    mname = "2x16x16" if multi_pod else "16x16"
    SH.set_mesh(TMESH.abstract_production_mesh(multi_pod))
    try:
        specs = D.cell_specs(TC.get_config(arch), shape)
    finally:
        SH.set_mesh(None)
    fsdp = int(shape == "train_4k")
    wants = {"params": ref_shards[f"params/{mname}/{arch}/{fsdp}"],
             "inputs": ref_shards[f"inputs/{mname}/{arch}/{shape}"]}
    if "opt" in specs:
        wants["opt"] = ref_shards[f"opt/{mname}/{arch}"]
    for part, want in wants.items():
        flat = TR.flatten(specs[part])
        assert sorted(p for p, _ in flat) == sorted(want), part
        shards = {p: list(s.sharding.shard_shape(s.shape)) if s.sharding
                  else list(s.shape) for p, s in flat}
        assert shards == want, part
        assert D.per_device_bytes(specs[part]) == sum(
            int(np.prod(want[p])) * s.dtype.itemsize for p, s in flat)


def test_collective_bytes_match_reference(ref_cells):
    got = D.collective_bytes(ref_cells["hlo"])
    assert got == ref_cells["collective_bytes"]
    assert got["count"] == 3 and all(got[k] > 0 for k in (
        "all-reduce", "all-gather", "all-to-all"))


def _scan_of_dots_hlo() -> str:
    """HLO of a rolled ``lax.scan`` of 8 dots, compiled by the reference's
    JAX here (one CPU device)."""
    def f(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, ws)[0]
    x = jnp.ones((4, 16), jnp.float32)
    ws = jnp.ones((8, 16, 16), jnp.float32)
    return jax.jit(f).lower(x, ws).compile().as_text()


def test_hlo_analysis_matches_reference_with_trip_counts():
    text = _scan_of_dots_hlo()
    want, got = RHA.analyze(text), THA.analyze(text)
    assert got == want
    # the loop's dot counted 8 times: 2 x 4 x 16 x 16 flops each
    assert want["dot_flops"] == 8 * 2 * 4 * 16 * 16 and want["while_count"]
    rc, tc = RHA.parse_module(text), THA.parse_module(text)
    assert {k: dataclasses.asdict(v) for k, v in tc.items()} == \
        {k: dataclasses.asdict(v) for k, v in rc.items()}
    assert THA.build_multipliers(tc) == RHA.build_multipliers(rc)


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------

TINY = {"tiny_train": dict(seq_len=16, global_batch=2, step="train"),
        "tiny_prefill": dict(seq_len=16, global_batch=2, step="prefill"),
        "tiny_decode": dict(seq_len=16, global_batch=2, step="decode")}


@pytest.mark.parametrize("arch,shape", [
    ("rwkv6_7b", "tiny_train"),          # the recurrence, fwd and bwd
    ("jamba_v0_1_52b", "tiny_prefill"),  # Mamba, MoE and attention
    ("whisper_base", "tiny_train"),      # encoder-decoder, backward
    ("gemma2_27b", "tiny_decode")])      # window and softcap, caches
def test_meta_counts_equal_a_real_cpu_run(monkeypatch, arch, shape):
    """The same step at smoke size on meta and on the CPU with real
    tensors: the meta run's trip-counted loops give the real run's
    flops exactly."""
    for k, v in TINY.items():
        monkeypatch.setitem(D.SHAPES, k, v)
    cfg = TC.get_smoke(arch)
    specs = D.input_specs(cfg, shape)
    ocfg = D.train_step_fn(cfg)[1] if shape == "tiny_train" else None
    meta = D.count_step(D.step_runner(cfg, shape, TT.abstract_params(cfg),
                                      specs, ocfg))
    params = TT.init_params(cfg, 0, device="cpu")
    real = D.count_step(D.step_runner(cfg, shape, params, specs, ocfg))
    assert meta["counted_flops"] == real["counted_flops"] > 0
    assert meta["hbm_bytes_proxy"] > 0 and real["hbm_bytes_proxy"] > 0


@pytest.mark.parametrize("arch,shape", [
    ("whisper_base", "train_4k"), ("mixtral_8x22b", "prefill_32k"),
    ("rwkv6_7b", "decode_32k")])
def test_run_cell_records_one_cell_of_each_step_kind(tmp_path, arch, shape):
    rec = D.run_cell(arch, shape, False, out_dir=str(tmp_path),
                     verbose=False)
    with open(tmp_path / f"dryrun_{arch}_{shape}_16x16.json") as f:
        assert json.load(f) == rec
    assert SH.current_mesh() is None
    assert rec["chips"] == 256 and rec["collectives"] is None
    assert rec["fsdp"] == (shape == "train_4k")
    assert 0.5 < rec["counted_flops"] / rec["model_flops"] < 40
    assert rec["hbm_bytes_proxy"] > 0 and rec["param_bytes_per_device"] > 0
    assert (rec["opt_bytes_per_device"] > 0) == (shape == "train_4k")


def test_main_skips_marked_cells_and_writes_under_build(tmp_path, capsys,
                                                        monkeypatch):
    assert D.RESULTS_DIR.endswith(os.path.join("build", "dryrun"))
    monkeypatch.setattr(D, "cells", lambda: [
        ("rwkv6_7b", "long_500k", None),
        ("gemma_7b", "long_500k", "full quadratic attention at 500k")])
    D.main(["--all", "--mesh", "both", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "SKIP gemma_7b x long_500k: full quadratic attention" in out
    assert out.rstrip().endswith("dry-run complete")
    assert sorted(os.listdir(tmp_path)) == [
        "dryrun_rwkv6_7b_long_500k_16x16.json",
        "dryrun_rwkv6_7b_long_500k_2x16x16.json"]
