"""Public serving-side face of the fault-injection layer (PyTorch twin
of ``repro.serve.faults``).

The registry itself lives in ``repro_torch.faults`` (import-light, so
``storage``/``exec``/``core`` instrument their edges without importing
the serving package); this module re-exports it for serving code and
adds the canonical *chaos schedule*: one window per fault class, so
one serving run trips every recovery path of ``serve.runtime``.
"""

from __future__ import annotations

from repro_torch.faults import FAULTS, FaultRegistry, FaultRule  # noqa: F401

#: every fault class a chaos run must inject at least once
#: (site, kind) — asserted against ``FAULTS.stats`` by the smoke gate
CHAOS_CLASSES = (
    ("storage.footer", "corrupt"),
    ("storage.chunk", "missing"),
    ("storage.chunk", "torn"),
    ("storage.chunk", "corrupt"),
    ("codegen.compile", "fail"),
    ("codegen.compile", "delay"),
    ("dist.exchange", "fail"),
    ("dist.imbalance", "inflate"),
    ("serve.cache_evict", "evict"),
)


def arm_chaos_schedule(seed: int = 0, *,
                       chunk_calls: int = 40,
                       compile_calls: int = 1) -> None:
    """Reset the registry under ``seed`` and arm one deterministic
    window per fault class, spread over each site's call sequence so
    one serving run trips every recovery path. ``chunk_calls`` /
    ``compile_calls`` roughly scale the windows to how often the run
    will hit each site (call indices are the only clock).

    ``chunk_calls`` is the approximate per-request stride of the
    ``storage.chunk`` site; the three chunk faults are spread 2x apart
    so each lands on a DIFFERENT request (a fault consumes a retry, and
    stacking all three on one request would exhaust its budget — the
    point is one recovery path per request, not a single doomed one)."""
    FAULTS.reset(seed)
    # storage: one corrupt footer read, then one missing / torn /
    # bit-flipped chunk spread over distinct requests
    FAULTS.arm("storage.footer", "corrupt", first=0, count=1)
    FAULTS.arm("storage.chunk", "missing", first=2 * chunk_calls + 2,
               count=1)
    FAULTS.arm("storage.chunk", "torn", first=4 * chunk_calls, count=1,
               arg=0.5)
    FAULTS.arm("storage.chunk", "corrupt", first=6 * chunk_calls,
               count=1)
    # compile: one failure (retried), one latency spike (absorbed)
    FAULTS.arm("codegen.compile", "fail", first=0, count=1)
    FAULTS.arm("codegen.compile", "delay", first=compile_calls, count=1,
               arg=0.005)
    # distribution: one failed exchange (retry -> local fallback) and
    # one inflated receive-load reading (degrade to local)
    FAULTS.arm("dist.exchange", "fail", first=0, count=1)
    FAULTS.arm("dist.imbalance", "inflate", first=0, count=1, arg=100.0)
    # serving: one mid-flight plan-cache eviction (transparent
    # recompile)
    FAULTS.arm("serve.cache_evict", "evict", first=3, count=1)


def chaos_coverage() -> dict:
    """{(site, kind): times fired} for the chaos classes — the smoke
    gate asserts every class fired at least once."""
    return {(site, kind): FAULTS.stats.get(f"{site}:{kind}", 0)
            for site, kind in CHAOS_CLASSES}
