"""The port's sharding rules, meshes and the transformer's sharding
surface against the reference on the CPU: ``logical_to_physical`` and
``pspec`` over every logical axis and the three mesh layouts,
``param_pspecs`` and ``param_defs(fsdp=True)``'s axes for all ten
configs, and the shard shape of every parameter leaf on both production
meshes with FSDP on and off, against the reference's
``NamedSharding.shard_shape`` (computed in a child process with 512 host
devices, ``_torch_dryrun_ref.py``). The rules read axis names only, so
the port lays them out on an ``AbstractMesh``; ``constrain`` is the
identity without a mesh and on meshes that hold no devices, and
``make_production_mesh`` refuses without a process group."""

from types import SimpleNamespace

import pytest
import torch

from repro import configs as RC
from repro.models import sharding as RSH
from repro.models import transformer as RT
from repro_torch import configs as TC
from repro_torch import tree as TR
from repro_torch.exec.dist import VirtualMesh
from repro_torch.launch import mesh as TMESH
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as TT

import _torch_dryrun_ref

AXIS_SETS = [("data",), ("data", "model"), ("pod", "data", "model")]
LOGICAL = ["dp", "sp", "model", None, "expert"]


@pytest.fixture
def meshes():
    """``use(names)``: both packages' meshes set to axes ``names`` (the
    reference's a stand-in with those axis names, all its rules read);
    both unset afterwards."""
    def use(names):
        RSH.set_mesh(SimpleNamespace(axis_names=names))
        SH.set_mesh(SH.AbstractMesh((2,) * len(names), names))

    try:
        yield use
    finally:
        RSH.set_mesh(None)
        SH.set_mesh(None)


@pytest.mark.parametrize("names", AXIS_SETS, ids="-".join)
def test_logical_axes_and_pspecs_match_reference(meshes, names):
    meshes(names)
    for a in LOGICAL:
        assert SH.logical_to_physical(a) == RSH.logical_to_physical(a), a
    for axes in [(a,) for a in LOGICAL] + [("dp", None, "model"),
                                           ("dp", "sp", None), ()]:
        got, want = SH.pspec(*axes), RSH.pspec(*axes)
        assert isinstance(got, SH.PartitionSpec)
        assert tuple(got) == tuple(want), (axes, got, want)
        assert got == tuple(want)


def test_rules_without_a_mesh_are_no_ops():
    SH.set_mesh(None)
    assert SH.current_mesh() is None
    assert SH.logical_to_physical("dp") is None
    assert tuple(SH.pspec("dp", "model")) == (None, None)
    assert SH.named_sharding("dp") is None
    x = torch.randn(2, 3)
    assert SH.constrain(x, "dp", None) is x


@pytest.mark.parametrize("mesh", [
    VirtualMesh(4, "data", device="cpu"),
    SH.AbstractMesh((16, 16), ("data", "model"))], ids=["virtual", "abstract"])
def test_constrain_is_the_identity_on_meshes_without_devices(mesh):
    SH.set_mesh(mesh)
    try:
        x = torch.randn(4, 16, 8)
        assert SH.constrain(x, "dp", "model", None) is x
        ns = SH.named_sharding("dp", None)
        assert ns.mesh is mesh and tuple(ns.spec) == ("data", None)
    finally:
        SH.set_mesh(None)


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_param_pspecs_and_fsdp_axes_match_reference(meshes, arch):
    rc, tc = RC.get_config(arch), TC.get_config(arch)
    for fsdp in (False, True):
        want = {p: pd.axes
                for p, pd in _ref_leaves(RT.param_defs(rc, fsdp=fsdp))}
        got = {p: pd.axes for p, pd in TR.flatten(TT.param_defs(tc,
                                                                fsdp=fsdp))}
        assert got == want, fsdp
    for names in AXIS_SETS[1:]:
        meshes(names)
        want = {p: tuple(s) for p, s in _ref_leaves(RT.param_pspecs(rc))}
        got = {p: tuple(s) for p, s in TR.flatten(TT.param_pspecs(tc))}
        assert got == want, names


def _ref_leaves(tree):
    """(path, leaf) of a reference tree whose leaves are PDs or specs."""
    import jax
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (RT.PD, tuple)))[0]
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in flat]


@pytest.fixture(scope="module")
def ref_shards():
    return _torch_dryrun_ref.reference("shards")


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_param_shard_shapes_match_reference(ref_shards, arch, multi_pod,
                                            fsdp):
    mesh = TMESH.abstract_production_mesh(multi_pod)
    mname = "2x16x16" if multi_pod else "16x16"
    SH.set_mesh(mesh)
    try:
        cfg = TC.get_config(arch)
        shardings = TT.param_shardings(cfg, fsdp=fsdp)
        got = {p: list(s.shard_shape(x.shape)) for (p, x), s in zip(
            TR.flatten(TT.abstract_params(cfg)), TR.leaves(shardings))}
    finally:
        SH.set_mesh(None)
    assert got == ref_shards[f"params/{mname}/{arch}/{int(fsdp)}"]


def test_abstract_params_are_meta_tensors_of_the_model_dtype():
    for arch in RC.ARCHS:
        cfg = TC.get_config(arch)
        ab = TT.abstract_params(cfg)
        defs = dict(TR.flatten(TT.param_defs(cfg)))
        for path, t in TR.flatten(ab):
            assert t.device.type == "meta" and t.dtype == TT.model_dtype(cfg)
            assert tuple(t.shape) == defs[path].shape, path


def test_production_meshes():
    shape, axes = TMESH.production_shape(False)
    assert (shape, axes) == ((16, 16), ("data", "model"))
    mp = TMESH.abstract_production_mesh(True)
    assert mp.axis_names == ("pod", "data", "model") and mp.size == 512
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs a process group of "
                                               f"{need} ranks"):
            TMESH.make_production_mesh(multi_pod=multi_pod)
    qm = TMESH.make_query_mesh(8, device="cpu")
    assert isinstance(qm, VirtualMesh) and qm.axis_names == ("data",)
    assert qm.shape == {"data": 8}


def test_shard_shape_refuses_uneven_splits():
    mesh = SH.AbstractMesh((16,), ("model",))
    with pytest.raises(ValueError, match="16 ways"):
        SH.NamedSharding(mesh, SH.PartitionSpec(None, "model")).shard_shape((4, 24))
    assert SH.NamedSharding(mesh, SH.PartitionSpec(("model",), None)).shard_shape(
        (32, 5)) == (2, 5)


_GROUP_CHILD = """
import sys
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import mesh as M
from repro_torch.models import sharding as SH

dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                        world_size=1, rank=0)
try:
    try:
        M.make_production_mesh()
        raise SystemExit("a group of 1 rank built the 16x16 mesh")
    except RuntimeError as e:
        assert "256 ranks" in str(e) and "has 1" in str(e), e
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    SH.set_mesh(mesh)
    assert SH.axis_names(mesh) == ("data", "model")
    assert SH.axis_sizes(mesh) == {{"data": 1, "model": 1}}
    x = distribute_tensor(torch.arange(32.0).reshape(4, 8), mesh,
                          [Replicate(), Replicate()])
    y = SH.constrain(x, "dp", "model")
    assert tuple(y.placements) == (Shard(0), Shard(1)), y.placements
    assert torch.equal(y.full_tensor(), x.full_tensor())
    z = SH.constrain(y, None, None)
    assert tuple(z.placements) == (Replicate(), Replicate()), z.placements
    plain = torch.ones(3)
    assert SH.constrain(plain, "dp") is plain
    assert SH.named_sharding("dp", None).shard_shape((4, 8)) == (4, 8)
finally:
    dist.destroy_process_group()
print("OK")
"""


def test_constrain_redistributes_a_dtensor_on_a_device_mesh():
    """On a torch DeviceMesh (a one-rank gloo group on the CPU, in a
    child process) ``constrain`` redistributes a DTensor to the logical
    axes' placements, and ``make_production_mesh`` names the ranks it
    needs beside the group's."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    res = subprocess.run(
        [sys.executable, "-c", _GROUP_CHILD.format(src=src, port=port)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "OK" in res.stdout, \
        res.stdout + res.stderr[-4000:]
