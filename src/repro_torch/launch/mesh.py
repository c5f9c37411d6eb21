"""Production mesh construction.

PyTorch twin of ``repro.launch.mesh``. Defined as FUNCTIONS, so that
importing this module touches no device and no process group."""

from __future__ import annotations

from ..models.sharding import AbstractMesh


def production_shape(multi_pod: bool = False):
    """The production mesh's (shape, axis names): 16x16 = 256 chips per
    pod; multi-pod = 2 pods = 512 chips with a leading "pod" axis."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def abstract_production_mesh(multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axes and sizes without devices (the
    dry-run's)."""
    return AbstractMesh(*production_shape(multi_pod))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh as a torch ``DeviceMesh`` over the ranks of the
    process group that is up, one card a rank. It needs 256 ranks (512
    with ``multi_pod``) and raises otherwise."""
    import torch.distributed as dist
    shape, axes = production_shape(multi_pod)
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} production mesh needs a "
            f"process group of {need} ranks, one card each; "
            + (f"the group has {have}" if have else "none is up"))
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_query_mesh(n_partitions: int, axis: str = "data", device=None):
    """1-D mesh for the distributed query engine: ``n_partitions`` sites
    of a virtual mesh on one device, the GPU unless ``device`` says
    otherwise (``exec.dist.device_mesh_1d``)."""
    from ..exec.dist import device_mesh_1d
    return device_mesh_1d(n_partitions, axis, device)
