"""The reference's sharding and dry-run arithmetic, computed in a child
process: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512
host devices before JAX starts, and the production meshes need them.
``reference(what)`` returns what the child printed as JSON:

* ``"shards"``: per (mesh, arch, fsdp) the shard shape of every
  parameter leaf (``NamedSharding.shard_shape``; the error's text where
  it raises), per (mesh, arch) those of the optimizer state under the
  dry-run's FSDP rule, and per (mesh, arch, shape) those of the inputs;
* ``"cells"``: per cell of ``configs.cells()`` the reference's
  ``model_flops`` and ``param_bytes_total``, and the HLO text of a small
  8-device program with collectives beside ``collective_bytes`` of it.
"""

import json
import os
import subprocess
import sys

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, sys
sys.path.insert(0, {src!r})
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.launch import dryrun as D
from repro.launch.mesh import make_production_mesh
from repro.models import sharding as SH
from repro.models import transformer as T
from repro.configs import ARCHS, SHAPES, cells, get_config
from repro.train.train_loop import train_step_fn

what = {what!r}


def path_str(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)


def shards(tree, shardings=None):
    out = {{}}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sh = jax.tree.leaves(shardings) if shardings is not None else None
    for i, (path, leaf) in enumerate(flat):
        s = sh[i] if sh is not None else leaf.sharding
        if s is None:
            out[path_str(path)] = list(leaf.shape)
            continue
        try:
            out[path_str(path)] = list(s.shard_shape(leaf.shape))
        except ValueError as e:
            out[path_str(path)] = "error: " + str(e)[:80]
    return out


res = {{}}
if what == "shards":
    for mp in (False, True):
        mname = "2x16x16" if mp else "16x16"
        SH.set_mesh(make_production_mesh(multi_pod=mp))
        for arch in ARCHS:
            cfg = get_config(arch)
            ab = T.abstract_params(cfg)
            for fsdp in (False, True):
                res["params/%s/%s/%d" % (mname, arch, fsdp)] = shards(
                    ab, T.param_shardings(cfg, fsdp=fsdp))
            ocfg = train_step_fn(cfg)[1]
            osh = D.opt_shardings(ocfg, cfg, fsdp=D.USE_FSDP_TRAIN)
            res["opt/%s/%s" % (mname, arch)] = shards(
                D.abstract_opt_state(ocfg, cfg, osh))
            for shape in SHAPES:
                res["inputs/%s/%s/%s" % (mname, arch, shape)] = shards(
                    D.input_specs(cfg, shape))
else:
    for arch, shape, skip in cells():
        cfg = get_config(arch)
        mf = D.model_flops(cfg, shape)
        mf["param_bytes_total"] = sum(
            int(np.prod(x.shape)) * x.dtype.itemsize
            for x in jax.tree.leaves(T.abstract_params(cfg)))
        res["cell/%s/%s" % (arch, shape)] = mf
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("pod", "data"))

    def body(x, w):
        y = jax.lax.psum(x @ w, "data")                     # all-reduce
        g = jax.lax.all_gather(y, "data", tiled=True)       # all-gather
        return jax.lax.all_to_all(g, "data", 0, 0, tiled=True)

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P("pod", "data"), P("data", None)),
                              out_specs=P("pod", "data"), check_vma=False))
    x = jnp.ones((16, 32), jnp.float32)
    w = jnp.ones((32, 8), jnp.float32)
    hlo = f.lower(x, w).compile().as_text()
    res["hlo"] = hlo
    res["collective_bytes"] = D.collective_bytes(hlo)
print(json.dumps(res))
"""


def reference(what: str) -> dict:
    code = _CHILD.format(src=SRC, what=what)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])
