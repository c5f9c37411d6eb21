"""The port's int8 gradient compression against the reference on the CPU:
``quantize_int8``'s codes and scales bit for bit (ties at halves, zeros,
an all-zero vector), ``compressed_psum_mean``'s mean and new residual on
every site of 1-, 2- and 8-site meshes (lengths the sites do not
divide), and ``tree_compressed_mean`` over a smoke config's gradient
tree for two rounds of error feedback, plus the reference's own
round-trip test (``tests/test_train.py``) on the port.

The reference runs under ``shard_map`` on 8 CPU devices in a child
process, compiled with XLA's fusion and algebraic-simplifier passes off
(``PER_OP_FLAGS``), so that it rounds op by op as it does run eagerly
(``jax.disable_jit()``, too slow here): with them on, XLA's CPU code
contracts ``x - q * scale`` into a fused multiply-add and divides by 127
as a product with its reciprocal, which the port does not. Inputs come
from numpy seeds."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.train.compression import dequantize_int8 as r_dequantize
from repro.train.compression import quantize_int8 as r_quantize
from repro_torch import configs as TC
from repro_torch import tree as TR
from repro_torch.exec.dist import DistContext, device_mesh_1d, run_on_sites
from repro_torch.models import transformer as TT
from repro_torch.train import train_loop as TL
from repro_torch.train.compression import (compressed_psum_mean,
                                           dequantize_int8, quantize_int8,
                                           tree_compressed_mean)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
PER_OP_FLAGS = "--xla_disable_hlo_passes=fusion,algsimp"


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else \
        a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def quantize_cases() -> dict:
    rng = np.random.RandomState(0)
    return {
        "normal": rng.randn(1000).astype(np.float32),
        # scale 1 (127 / 127 + 1e-12 rounds to 1 in f32): every x / scale
        # is x, so the halves are ties, rounded to even
        "halves": np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                            -126.5, 3.5, 4.5, -127], np.float32),
        "zeros": np.array([0, 0, 0, 1e-3, -2, 0, -0.0], np.float32),
        "all_zero": np.zeros(8, np.float32),
        "tiny": np.array([1e-13, -5e-14, 0, 3e-14], np.float32),
        "wide": (rng.randn(517) * 10.0 ** rng.uniform(-20, 20, 517)
                 ).astype(np.float32),
    }


@pytest.mark.parametrize("case", sorted(quantize_cases()))
def test_codes_and_scales_bit_equal_to_reference(case):
    x = quantize_cases()[case]
    rq, rs = r_quantize(jnp.asarray(x))
    tq, ts = quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert bits(ts.numpy()) == bits(np.float32(rs))
    np.testing.assert_array_equal(
        bits(dequantize_int8(tq, ts).numpy()),
        bits(np.asarray(r_dequantize(rq, rs))))


def test_quantize_roundtrip_error_bounded():
    """``tests/test_train.py``'s case, on the port."""
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(1000), dtype=torch.float32)
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-6


# ---------------------------------------------------------------------------
# compressed_psum_mean and tree_compressed_mean against the reference
# ---------------------------------------------------------------------------

# (sites, length): lengths 8 and 2 do not divide, one shorter than 8
PSUM_CASES = [(1, 1003), (2, 1003), (2, 1024), (8, 1003), (8, 1024),
              (8, 5)]


def psum_inputs(n: int, length: int, seed: int) -> tuple:
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, length) * 10.0 ** rng.uniform(-3, 1, (n, 1))
         ).astype(np.float32)
    r = (rng.randn(n, length) * 1e-3).astype(np.float32)
    if length:
        x[0, 0] = 0.0                      # a site's exact zero
    return x, r


def grad_tree(arch: str = "gemma2_27b") -> list:
    """Two sites' gradients of a smoke config (one half batch each), in
    f32, as [(path, (2, ...) array)]."""
    cfg = TC.get_smoke(arch)
    params = TT.init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab, (4, 9))
    grads = []
    for half in (toks[:2], toks[2:]):
        batch = {"tokens": torch.as_tensor(half[:, :-1]),
                 "labels": torch.as_tensor(half[:, 1:])}
        _, g = TL.value_and_grad(TL.make_loss(cfg), params, batch)
        grads.append(g)
    return [(path, np.stack([a.float().numpy(), b.float().numpy()]))
            for (path, a), b in zip(TR.flatten(grads[0]),
                                    TR.leaves(grads[1]))]


_CHILD = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 " \
    + {flags!r}
import sys
sys.path.insert(0, {src!r})
import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.train.compression import compressed_psum_mean, tree_compressed_mean

z = dict(np.load({inp!r}))
out = {{}}


def on_sites(fn, n, *args):
    mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("pod"),
                                 out_specs=P("pod")))(*args)


for key in [k for k in z if k.startswith("psum/") and k.endswith("/x")]:
    case = key[:-2]
    x, r = z[case + "/x"], z[case + "/r"]
    n = x.shape[0]
    m, nr = on_sites(lambda a, b: tuple(t[None] for t in compressed_psum_mean(
        a[0], "pod", n, b[0])), n, x, r)
    out[case + "/mean"], out[case + "/res"] = np.asarray(m), np.asarray(nr)

paths = sorted(k[5:] for k in z if k.startswith("tree/"))
grads = {{p: z["tree/" + p] for p in paths}}
res = {{p: np.zeros_like(g) for p, g in grads.items()}}
for rnd in (0, 1):
    m, res = on_sites(lambda g, r: tuple(
        {{p: v[None] for p, v in t.items()}} for t in tree_compressed_mean(
            {{p: v[0] for p, v in g.items()}}, "pod", 2,
            {{p: v[0] for p, v in r.items()}})), 2, grads, res)
    for p in paths:
        out["tree/%d/mean/%s" % (rnd, p)] = np.asarray(m[p])
        out["tree/%d/res/%s" % (rnd, p)] = np.asarray(res[p])
np.savez({outp!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference():
    """(inputs, the reference's outputs), from the child process."""
    inputs = {}
    for i, (n, length) in enumerate(PSUM_CASES):
        x, r = psum_inputs(n, length, i)
        inputs[f"psum/{n}x{length}/x"] = x
        inputs[f"psum/{n}x{length}/r"] = r
    for path, g in grad_tree():
        inputs["tree/" + path.replace("/", ".")] = g
    with tempfile.TemporaryDirectory() as td:
        inp, outp = os.path.join(td, "in.npz"), os.path.join(td, "out.npz")
        np.savez(inp, **inputs)
        res = subprocess.run(
            [sys.executable, "-c", _CHILD.format(src=SRC, inp=inp, outp=outp,
                                                 flags=PER_OP_FLAGS)],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert res.returncode == 0, res.stderr[-4000:]
        with np.load(outp) as z:
            outs = {k: z[k] for k in z.files}
    return inputs, outs


def port_psum(x: np.ndarray, r: np.ndarray) -> list:
    n = x.shape[0]
    mesh = device_mesh_1d(n, "pod", device="cpu")
    return run_on_sites(mesh, lambda ctx: compressed_psum_mean(
        torch.from_numpy(x[ctx.site]), "pod", n,
        torch.from_numpy(r[ctx.site]), ctx))


@pytest.mark.parametrize("n,length", PSUM_CASES)
def test_psum_mean_and_residual_equal_reference_on_every_site(reference,
                                                              n, length):
    inputs, outs = reference
    case = f"psum/{n}x{length}"
    got = port_psum(inputs[case + "/x"], inputs[case + "/r"])
    for site, (mean, res) in enumerate(got):
        assert mean.shape == (length,) and res.shape == (length,)
        np.testing.assert_array_equal(bits(mean.numpy()),
                                      bits(outs[case + "/mean"][site]),
                                      err_msg=f"{case} site {site} mean")
        np.testing.assert_array_equal(bits(res.numpy()),
                                      bits(outs[case + "/res"][site]),
                                      err_msg=f"{case} site {site} residual")


def test_tree_mean_equals_reference_over_two_rounds(reference):
    """A smoke config's gradient tree on two sites, two rounds with the
    residuals carried: every leaf's mean and residual bit-equal."""
    inputs, outs = reference
    paths = sorted(k[5:] for k in inputs if k.startswith("tree/"))
    grads = {p: inputs["tree/" + p] for p in paths}
    res = {p: np.zeros_like(g) for p, g in grads.items()}
    mesh = device_mesh_1d(2, "pod", device="cpu")
    for rnd in (0, 1):
        got = run_on_sites(mesh, lambda ctx: tree_compressed_mean(
            {p: torch.from_numpy(g[ctx.site]) for p, g in grads.items()},
            "pod", 2, {p: torch.from_numpy(r[ctx.site])
                       for p, r in res.items()}, ctx))
        for p in paths:
            for site in (0, 1):
                np.testing.assert_array_equal(
                    bits(got[site][0][p].numpy()),
                    bits(outs[f"tree/{rnd}/mean/{p}"][site]), err_msg=p)
                np.testing.assert_array_equal(
                    bits(got[site][1][p].numpy()),
                    bits(outs[f"tree/{rnd}/res/{p}"][site]), err_msg=p)
        res = {p: np.stack([got[0][1][p].numpy(), got[1][1][p].numpy()])
               for p in paths}
    assert len(paths) > 10


# ---------------------------------------------------------------------------
# the port's own properties
# ---------------------------------------------------------------------------

def test_residual_identity_is_exact_and_runs_repeat_bit_for_bit():
    """x + residual_in == sent + residual_out in f32, sent being the
    whole vector's codes times its scale; two runs bit-identical."""
    x, r = psum_inputs(2, 1003, 7)
    runs = [port_psum(x, r) for _ in range(2)]
    for site in (0, 1):
        xs = torch.from_numpy(x[site]) + torch.from_numpy(r[site])
        sent = dequantize_int8(*quantize_int8(xs))
        assert torch.equal(sent + runs[0][site][1], xs)
        for a, b in zip(runs[0][site], runs[1][site]):
            assert np.array_equal(bits(a.numpy()), bits(b.numpy()))


def test_error_within_the_bound_of_the_codes():
    """|mean - exact mean| per element within each site's scale / 2 over
    n plus the re-quantization's scale / 2 (and f32 rounding)."""
    n, length = 8, 1003
    x, r = psum_inputs(n, length, 11)
    got = port_psum(x, r)
    xs = (x.astype(np.float64) + r)
    exact = xs.mean(0)
    pad = (-length) % n
    chunks = np.pad(xs, ((0, 0), (0, pad))).reshape(n, n, -1)
    site_scales = np.abs(chunks).max(2) / 127.0          # (site, chunk)
    mean = got[0][0].numpy().astype(np.float64)
    local = np.pad(mean, (0, pad)).reshape(n, -1)
    requant = np.abs(local).max(1) / 127.0               # upper bound
    bound = (site_scales.sum(0) / 2 / n + requant / 2 + 1e-6 * (
        np.abs(chunks).max((0, 2)) + 1e-30))
    err = np.abs(np.pad(mean - exact, (0, pad))).reshape(n, -1).max(1)
    assert (err <= bound).all(), (err, bound)
    for site in range(1, n):
        assert torch.equal(got[site][0], got[0][0])


def test_one_site_builds_its_own_context_and_others_need_one():
    x = torch.randn(100)
    m, nr = compressed_psum_mean(x, "pod", 1, torch.zeros(100))
    q, s = quantize_int8(x)
    assert torch.equal(m, dequantize_int8(*quantize_int8(
        dequantize_int8(q, s))))
    with pytest.raises(ValueError, match="needs the site's DistContext"):
        compressed_psum_mean(x, "pod", 2, torch.zeros(100))
    ctx = DistContext("data", 1, device="cpu")
    with pytest.raises(ValueError, match="axis 'data'"):
        compressed_psum_mean(x, "pod", 1, torch.zeros(100), ctx)
