"""The port's public signatures against the reference's: every public
top-level function of every module that ``src/repro_torch`` mirrors takes
the reference's parameters (names, kinds and defaults; annotations are
each package's own), but for the deliberate differences listed below,
each with its reason. The reference's signatures are read in a child
process, because importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``
for 512 host devices before JAX starts."""

import inspect
import importlib
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")

# modules of the port with no twin in the reference
PORT_OWN = {"kernels.build", "tree", "figures", "figures.biomedical",
            "figures.common", "figures.representation", "figures.succinct",
            "figures.tpch_nested", "data", "launch", "train"}

ADDED = "an argument the port adds at the end; the reference's calls stay " \
        "valid"
# (module, function) -> why the port's signature differs
DELIBERATE = {
    ("core.codegen", "columnar_shred_inputs"):
        "device: where the shredded bags go (" + ADDED + ")",
    ("exec.dist", "device_mesh_1d"):
        "device: the virtual mesh's device (" + ADDED + ")",
    ("models.transformer", "init_cache"):
        "device: where the caches go (" + ADDED + ")",
    ("obs.explain", "explain_analyze"):
        "device: where shredded rows go (" + ADDED + ")",
    ("launch.mesh", "make_query_mesh"):
        "device: the virtual mesh's device (" + ADDED + ")",
    ("kernels.ops", "delta_unpack"):
        "out: decode into a column slice (" + ADDED + ")",
    ("kernels.ops", "bitunpack"):
        "out: decode into a column slice (" + ADDED + ")",
    ("kernels.ops", "dict_gather"):
        "out: decode into a column slice (" + ADDED + ")",
    ("kernels.ops", "rle_expand"):
        "takes the stored run lengths in place of (starts, ends), and out",
    ("kernels.ref", "rle_expand_ref"):
        "takes the stored run lengths in place of (starts, ends)",
    ("kernels.ref", "attention_ref"):
        "with_lse: the row log-sum-exp the backward needs (" + ADDED + ")",
    ("train.optim", "apply_updates"):
        "donate: write into the given tensors, the reference's "
        "donate_argnums (" + ADDED + ")",
    ("train.train_loop", "make_train_step"):
        "donate: as apply_updates' (" + ADDED + ")",
    ("train.train_loop", "train_step_fn"):
        "**kw: make_train_step's microbatches and donate",
    ("launch.train", "main"):
        "argv: the arguments, for callers other than the command line",
    ("launch.dryrun", "main"):
        "argv: the arguments, for callers other than the command line",
    ("models.transformer", "init_params"):
        "(cfg, seed, device): a seed for a torch.Generator in place of a "
        "JAX key",
    ("train.compression", "compressed_psum_mean"):
        "ctx: the site's DistContext, whose rendezvous holds the "
        "collectives that shard_map gives the reference (" + ADDED + ")",
    ("train.compression", "tree_compressed_mean"):
        "ctx: as compressed_psum_mean's (" + ADDED + ")",
}
# reference functions the port replaces, by module: the Pallas entry
# points, whose work the hand-written kernels do behind kernels.ops
PALLAS = "a Pallas entry point: the Hopper kernel behind kernels.ops does " \
         "its work"
REPLACED = {
    ("kernels.decode", "rle_expand_pallas"): PALLAS,
    ("kernels.decode", "delta_unpack_pallas"): PALLAS,
    ("kernels.decode", "bitunpack_pallas"): PALLAS,
    ("kernels.decode", "dict_gather_pallas"): PALLAS,
    ("kernels.flash_attention", "flash_attention_pallas"): PALLAS,
    ("kernels.gather_join", "merge_positions_pallas"): PALLAS,
    ("kernels.gather_join", "gather_rows_pallas"): PALLAS,
    ("kernels.rwkv6_scan", "rwkv6_pallas"): PALLAS,
    ("kernels.segment_fused", "segment_sum_first_pallas"): PALLAS,
    ("kernels.segment_reduce", "segment_reduce_pallas"): PALLAS,
    ("kernels.shuffle_pack", "pack_rows_pallas"): PALLAS,
    ("kernels.shuffle_pack", "replicate_scatter_pallas"): PALLAS,
    ("kernels.shuffle_pack", "member_mask_pallas"): PALLAS,
    ("kernels.shuffle_pack", "unpack_cols_pallas"): PALLAS,
}


def modules(pkg: str) -> list:
    """Dotted module names under ``src/<pkg>`` ("" for the package)."""
    out = []
    base = os.path.join(SRC, pkg)
    for dirpath, _, names in os.walk(base):
        for n in names:
            if not n.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, n), base)[:-3]
            rel = rel.replace(os.sep, ".")
            if rel == "__init__":
                rel = ""
            elif rel.endswith(".__init__"):
                rel = rel[:-len(".__init__")]
            out.append(rel)
    return sorted(out)


def signatures(pkg: str, mods: list) -> dict:
    """{module: {function: [(name, kind, repr(default) or None)]}} of
    every public function defined in the module."""
    out = {}
    for m in mods:
        name = pkg + ("." + m if m else "")
        mod = importlib.import_module(name)
        fns = {}
        for fn_name, obj in vars(mod).items():
            if fn_name.startswith("_") or not inspect.isfunction(obj) \
                    or obj.__module__ != name:
                continue
            fns[fn_name] = [
                [p.name, p.kind.name,
                 None if p.default is p.empty else repr(p.default)]
                for p in inspect.signature(obj).parameters.values()]
        out[m] = fns
    return out


_CHILD = """
import json, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
import test_torch_signatures as S
mods = [m for m in S.modules("repro") if m in set(S.modules("repro_torch"))]
print(json.dumps(S.signatures("repro", mods)))
"""


@pytest.fixture(scope="module")
def reference():
    code = _CHILD.format(src=SRC, tests=os.path.dirname(__file__))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


MIRRORED = [m for m in modules("repro") if m in set(modules("repro_torch"))]


def test_every_reference_module_has_a_twin():
    """The two module lists differ only by the port's own modules."""
    ref, port = set(modules("repro")), set(modules("repro_torch"))
    assert ref - port == set(), sorted(ref - port)
    assert port - ref == PORT_OWN, sorted((port - ref) ^ PORT_OWN)


@pytest.mark.parametrize("module", MIRRORED, ids=lambda m: m or "repro")
def test_public_signatures_match_reference(reference, module):
    want = reference[module]
    got = signatures("repro_torch", [module])[module]
    for fn, params in sorted(want.items()):
        if (module, fn) in REPLACED:
            assert fn not in got, (module, fn, "is replaced, yet defined")
            continue
        assert fn in got, f"{module}.{fn} has no counterpart in the port"
        if (module, fn) in DELIBERATE:
            assert got[fn] != params, \
                f"{module}.{fn} now matches; drop it from DELIBERATE"
            # the reference's leading parameters stay, but for the two
            # whose leading arguments differ by design
            if fn not in ("rle_expand", "rle_expand_ref", "init_params",
                          "main"):
                assert got[fn][:len(params)] == params, (module, fn)
            continue
        assert got[fn] == params, (module, fn, params, got[fn])


def test_listed_differences_name_real_functions(reference):
    for module, fn in list(DELIBERATE) + list(REPLACED):
        assert fn in reference[module], (module, fn)


def test_repairs_accept_the_reference_calls():
    """The three calls that the port refused before this slice."""
    import torch
    from repro_torch.kernels import ops
    assert ops.detect_backend() == ("cuda" if torch.cuda.is_available()
                                    else "cpu")
    q = torch.randn(1, 2, 8, 16, dtype=torch.float64)
    k, v = torch.randn(1, 1, 8, 16, dtype=torch.float64), \
        torch.randn(1, 1, 8, 16, dtype=torch.float64)
    assert torch.equal(ops.flash_attention(q, k, v, block_q=64, block_k=64),
                       ops.flash_attention(q, k, v))
    for bad in (0, -64, 1.5, True, "64"):
        with pytest.raises(ValueError, match="block_q"):
            ops.flash_attention(q, k, v, block_q=bad)
        with pytest.raises(ValueError, match="block_k"):
            ops.flash_attention(q, k, v, block_k=bad)
