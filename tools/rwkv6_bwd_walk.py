"""Times ``rwkv6_bwd``'s kernels as built and with the out kernel's walk
cut to dw alone, at the shape of RWKV-6 7B's layer in phase S of
``chip_smoke.py`` (B = 4, H = 64, T = 4096, K = V = 64, chunks of 64,
bfloat16, decays drawn in [0.2, 0.99] from a seed).

``csrc/rwkv6_bwd.cu`` is compiled twice with ``build.NVCC_FLAGS``: as
``build.py`` builds it, and with ``-DRWKV6_BWD_WALK_DW_ONLY``, where the
walk of ``rwkv6_bwd_out`` carries G and sums dw only and leaves dr, dk
and dv unset. The difference of the two ``rwkv6_bwd_out`` times is the
most that taking dr, dk and dv out of the walk (their intra-chunk matrix
form on the tensor cores, dw still walked) could save there, before the
time of that form's own products. The two builds' dw must be
bit-identical. Each kernel's device time comes from ``torch.profiler``
(``chip_smoke.device_ms``), beside its least bytes over the card's
memory rate (``chip_smoke.rwkv6_bwd_stage_bytes``).

Needs a CUDA card and nvcc: ``python3 tools/rwkv6_bwd_walk.py``.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rwkv6_scan as RW  # noqa: E402

SHAPE = (4, 64, 4096, 64, 64)   # B, H, T, K, V: phase S's layer
CHUNK = 64


def build_variants() -> dict:
    """{"as built": library, "dw only": library}, both compiled at once."""
    out = build.BUILD_DIR / "walk_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = str(build.CSRC / "rwkv6_bwd.cu")
    libs = {"as built": (out / "librwkv6_bwd_full.so", []),
            "dw only": (out / "librwkv6_bwd_dw_only.so",
                        ["-DRWKV6_BWD_WALK_DW_ONLY"])}
    procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, *flags,
                               "-o", str(path), src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for path, flags in libs.values()]
    for proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{text}")
    return {name: str(path) for name, (path, _) in libs.items()}


def launcher(path: str):
    f = ctypes.CDLL(path).rwkv6_bwd_launch
    f.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def inputs(dev, seed: int = 0) -> tuple:
    B, H, T, K, V = SHAPE
    rng = np.random.RandomState(seed)
    r, k = (rng.randn(B, H, T, K).astype(np.float32) * 0.5
            for _ in range(2))
    w = (0.2 + 0.79 * rng.rand(B, H, T, K)).astype(np.float32)
    v = rng.randn(B, H, T, V).astype(np.float32)
    do = rng.randn(B, H, T, V).astype(np.float32) * 0.1
    r, k, v, w, do = (torch.as_tensor(a, device=dev).to(torch.bfloat16)
                      for a in (r, k, v, w, do))
    u = torch.as_tensor(rng.randn(H, K).astype(np.float32) * 0.3,
                        device=dev)
    return r, k, v, w, u, do


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build_variants()
    args = inputs(dev)
    r, k, v, w, u, do = args
    kern = lambda: RW.rwkv6_bwd_cuda(*args, chunk=CHUNK)  # noqa: E731
    bound = CS.rwkv6_bwd_stage_bytes(r, v, u, CHUNK)
    print(CS.nvidia_smi(), flush=True)
    dws, out = {}, {}
    for name, path in libs.items():
        RW._BWD_FN = launcher(path)
        dws[name] = kern()[3]
        split = []
        (ms,), sessions = CS.device_ms([kern], [3],
                                       tries=CS.LM_REC_PROFILE_TRIES,
                                       split=split)
        events = CS.time_ms(kern, iters=5)
        stages = {op.split("(")[0].split("<")[0].replace("void ", "").strip():
                  t for op, t in split[0].items()}
        out[name] = stages
        print(f"[{name}] rwkv6_bwd at {SHAPE} (B, H, T, K, V), chunk "
              f"{CHUNK}, bf16: {events:.4f} ms by CUDA events, "
              f"{CS._ms(ms)} ms on the device (profile session {sessions});"
              f" by kernel: " + "; ".join(
                  f"{op} {t:.4f} ms" + (
                      f" (bound {bound[op] / CS.HBM_BYTES_PER_S * 1e3:.4f} "
                      f"ms by bytes)" if op in bound else "")
                  for op, t in stages.items()), flush=True)
    RW._BWD_FN = None
    same = torch.equal(dws["as built"].view(torch.int16),
                       dws["dw only"].view(torch.int16))
    full = out["as built"].get("rwkv6_bwd_out")
    cut = out["dw only"].get("rwkv6_bwd_out")
    if full is None or cut is None:
        print("rwkv6_bwd_out: not measured (no complete profile)")
        return 1
    print(f"rwkv6_bwd_out: {full:.4f} ms as built, {cut:.4f} ms with the "
          f"walk cut to dw (dw {'bit-identical' if same else 'DIFFERENT'}):"
          f" dr, dk and dv take {full - cut:.4f} ms ({(full - cut) / full:.1%}"
          f") of it", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
