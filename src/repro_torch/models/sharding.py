"""Logical-axis sharding helpers shared by models and the launcher.

PyTorch twin of ``repro.models.sharding``. Logical axes: "dp" (batch:
pod x data), "model" (tensor/expert parallel), "sp" (sequence: data
axis, long-context decode). The launcher installs the physical mesh;
without one every constraint is a no-op.

The rules read only the mesh's axis names (and, for shard shapes, their
sizes), so they work on any mesh object that has them: a torch
``DeviceMesh`` (``mesh_dim_names``), an ``AbstractMesh`` of names and
sizes (the dry-run's production meshes, which need no device), or an
``exec.dist.VirtualMesh``. Only a ``DeviceMesh`` moves data:
``constrain`` redistributes a ``DTensor`` on it, and returns anything
else unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

_MESH = None


def _entry(part):
    """A spec entry as JAX normalizes it: a tuple of one axis is that
    axis, an empty tuple None."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return None if not part else part[0] if len(part) == 1 else part
    return part


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per array dim, each None
    (replicated), a mesh axis name, or a tuple of them."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_entry(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class AbstractMesh:
    """A mesh of named axes and their sizes, with no devices: what the
    dry-run lays the production shardings out on."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    if names is None:                      # a torch DeviceMesh
        names = mesh.mesh_dim_names
    return tuple(names or ())


def axis_sizes(mesh) -> Dict[str, int]:
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), (int(s) for s in shape)))


class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a ``PartitionSpec``."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """Each dim divided by the sizes of the mesh axes its spec entry
        names; raises where they do not divide it, as JAX's does."""
        sizes = axis_sizes(self.mesh)
        out = []
        for dim, size in enumerate(global_shape):
            entry = self.spec[dim] if dim < len(self.spec) else None
            ways = 1
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    ways *= sizes[a]
            if size % ways:
                raise ValueError(
                    f"sharding {self.spec} splits axis {dim} of shape "
                    f"{tuple(global_shape)} {ways} ways")
            out.append(size // ways)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def set_mesh(mesh):
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


def logical_to_physical(axis: Optional[str]):
    if axis is None or _MESH is None:
        return None
    names = axis_names(_MESH)
    if axis == "dp":
        return tuple(a for a in ("pod", "data") if a in names) or None
    if axis == "sp":
        return "data" if "data" in names else None
    if axis == "model":
        return "model" if "model" in names else None
    return axis if axis in names else None


def pspec(*axes) -> PartitionSpec:
    return PartitionSpec(*[logical_to_physical(a) for a in axes])


def _placements(mesh, spec: PartitionSpec) -> list:
    """The DTensor placements of ``spec`` on a ``DeviceMesh``: each mesh
    dim shards the tensor dim whose entry names it, else replicates."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def constrain(x, *axes):
    """``with_sharding_constraint`` on logical axes: a ``DTensor`` on a
    ``DeviceMesh`` is redistributed to them; without a mesh, on a mesh
    that holds no devices of its own, or for a plain tensor, ``x`` comes
    back unchanged."""
    if _MESH is None or not hasattr(_MESH, "mesh_dim_names"):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(_MESH, _placements(_MESH, pspec(*axes)))


def named_sharding(*axes) -> Optional[NamedSharding]:
    if _MESH is None:
        return None
    return NamedSharding(_MESH, pspec(*axes))
