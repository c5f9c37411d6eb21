"""The port's fault-tolerant ``ServingRuntime`` against the reference's,
on the CPU and on a virtual clock.

Every case of ``tests/test_faults.py`` runs through both packages on the
same seeded inputs and the same fault windows: the typed errors, the
registry, admission control, deadlines, retries and backoff, the
circuit breaker, mid-flight eviction, the stored re-scan, the
crash-recoverable manifest and ``warm_replay``, batching, and the two
recovery-path parity cases (here on fixed specs, unmarked). Each case
holds the port's responses (``ok``, shed, error class, retries,
degradations), its ``stats``, ``FAULTS.stats`` and backoff sleeps to the
reference's, beside the reference test's own assertions. Manifest
entries are compared by kind, shape and count, never by family id (ids
hash each package's own key). The last case serves one request stream
under ``arm_chaos_schedule`` (``benchmarks/serving.py``'s chaos run at a
small size) and holds the whole sequence to the reference's.
"""

import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest

import test_differential as TD
from repro_torch.obs import reset_telemetry

from test_torch_queries import build_query, diff_catalog, diff_types
from test_torch_query_service import family, gen_data
from test_torch_query_service import types as qs_types

ERRORS = ("StorageError", "FooterError", "ChunkCorruptionError",
          "MissingChunkError", "CompileError", "ExchangeError",
          "CapacityOverflowError", "AdmissionError", "ShedError",
          "CircuitOpenError", "DeadlineExceeded")


def ref_side():
    import repro.errors as E
    from repro.core import codegen as CG
    from repro.core import interpreter as I
    from repro.core import nrc as N
    from repro.core.unnesting import Catalog
    from repro.exec.dist import device_mesh_1d
    from repro.faults import FAULTS, FaultRegistry
    from repro.serve import QueryRequest, QueryService, ServingRuntime
    from repro.serve import faults as SF
    from repro.storage import (DatasetWriter, StorageCatalog,
                               StoredDataset)
    from repro.storage.format import chunk_path
    return SimpleNamespace(
        name="ref", E=E, CG=CG, I=I, N=N, Catalog=Catalog, FAULTS=FAULTS,
        FaultRegistry=FaultRegistry, Request=QueryRequest,
        Service=QueryService, Runtime=ServingRuntime, SF=SF,
        Writer=DatasetWriter, Stored=StoredDataset, Storage=StorageCatalog,
        chunk_path=chunk_path, dev={}, mesh=lambda n: device_mesh_1d(n))


def port_side():
    import repro_torch.errors as E
    from repro_torch.core import codegen as CG
    from repro_torch.core import interpreter as I
    from repro_torch.core import nrc as N
    from repro_torch.core.unnesting import Catalog
    from repro_torch.exec.dist import device_mesh_1d
    from repro_torch.faults import FAULTS, FaultRegistry
    from repro_torch.serve import QueryRequest, QueryService, ServingRuntime
    from repro_torch.serve import faults as SF
    from repro_torch.storage import (DatasetWriter, StorageCatalog,
                                     StoredDataset)
    from repro_torch.storage.format import chunk_path
    return SimpleNamespace(
        name="port", E=E, CG=CG, I=I, N=N, Catalog=Catalog, FAULTS=FAULTS,
        FaultRegistry=FaultRegistry, Request=QueryRequest,
        Service=QueryService, Runtime=ServingRuntime, SF=SF,
        Writer=DatasetWriter, Stored=StoredDataset, Storage=StorageCatalog,
        chunk_path=chunk_path, dev={"device": "cpu"},
        mesh=lambda n: device_mesh_1d(n, device="cpu"))


SIDES = (ref_side(), port_side())


@pytest.fixture(autouse=True)
def _clean_registries():
    reset_telemetry()
    for S in SIDES:
        S.FAULTS.reset()
    yield
    for S in SIDES:
        S.FAULTS.reset()


class VirtualClock:
    """Deterministic time for the runtime: ``sleep`` advances ``now``."""

    def __init__(self):
        self.t = 0.0
        self.slept = []

    def now(self):
        return self.t

    def sleep(self, s):
        self.slept.append(s)
        self.t += s


def make_runtime(S, svc, **kw):
    vc = VirtualClock()
    rt = S.Runtime(svc, clock=vc.now, sleep=vc.sleep, seed=7, **S.dev,
                   **kw)
    return rt, vc


SPEC = dict(seed=5, n_orders=8, n_parts=5, zipf=0.0,
            shape="flat_agg", sel="qty_ge", selc=2)


def prog_for(S, spec):
    return S.N.Program([S.N.Assignment("Q", build_query(S.N, spec))])


def service(S, **kw):
    return S.Service(diff_types(S.N), catalog=diff_catalog(S.Catalog), **kw)


def resp(r) -> tuple:
    """What a response says, in names both packages share."""
    return (r.ok, r.shed, type(r.error).__name__ if r.error else None,
            r.retries, r.degraded)


def state(S, rt, vc=None, svc=None) -> tuple:
    return (dict(rt.stats), dict(S.FAULTS.stats),
            list(vc.slept) if vc is not None else None,
            dict(svc.stats) if svc is not None else None)


def both(scenario, *args) -> list:
    """Run ``scenario(S, *args)`` on each package; assert the port's
    facts equal the reference's; return them."""
    got = [scenario(S, *args) for S in SIDES]
    assert got[1] == got[0]
    return got[1]


@pytest.fixture(scope="module")
def served():
    """One compiled family on one local service per package (module
    scoped, as the reference test shares one compile)."""
    out = {}
    for S in SIDES:
        svc = service(S)
        out[S.name] = (svc, svc.shred_inputs(TD.gen_inputs(SPEC), **S.dev))
    return out


def with_served(served, scenario):
    return both(lambda S: scenario(S, *served[S.name]))


# ---------------------------------------------------------------------------
# typed errors and the registry
# ---------------------------------------------------------------------------

def test_error_hierarchy_and_transience():
    def facts(S):
        E = S.E
        for name in ERRORS:
            assert issubclass(getattr(E, name), E.ReproError)
        assert E.CompileError.transient and E.ExchangeError.transient \
            and E.CapacityOverflowError.transient
        assert not E.StorageError.transient and not E.ShedError.transient
        assert issubclass(E.ShedError, E.AdmissionError)
        assert issubclass(E.ChunkCorruptionError, E.StorageError)
        return [(n, bool(getattr(E, n).transient),
                 [c.__name__ for c in getattr(E, n).__mro__])
                for n in ERRORS]
    both(facts)


def test_registry_windows_match_and_determinism():
    def facts(S):
        reg = S.FaultRegistry(seed=3)
        reg.arm("s", "boom", first=2, count=2, part="A")
        fired = [bool(reg.hit("s", part=p))
                 for p in ("A", "A", "A", "B", "A", "A")]
        assert fired == [False, False, True, False, False, False]
        assert reg.stats == {"s:boom": 1}
        seqs = []
        for _ in range(2):
            reg = S.FaultRegistry(seed=11)
            reg.arm("s", "maybe", first=0, count=-1, p=0.4)
            seqs.append([bool(reg.hit("s")) for _ in range(30)])
        assert seqs[0] == seqs[1] and 0 < sum(seqs[0]) < 30
        reg.disarm()
        assert not reg.enabled
        return fired, seqs[0]
    both(facts)


def test_chaos_schedule_arms_every_class():
    def facts(S):
        S.SF.arm_chaos_schedule(seed=1)
        assert {(r.site, r.kind) for r in S.FAULTS.rules} \
            == set(S.SF.CHAOS_CLASSES)
        return [(r.site, r.kind, r.first, r.count, r.arg)
                for r in S.FAULTS.rules], S.SF.CHAOS_CLASSES
    both(facts)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_token_bucket_quota_sheds_and_refills(served):
    def scenario(S, svc, env):
        rt, vc = make_runtime(S, svc, tenant_rate=1.0, tenant_burst=2.0)
        rs = [rt.submit(S.Request(prog_for(S, SPEC), env))
              for _ in range(3)]
        assert [r.ok for r in rs] == [True, True, False]
        assert rs[2].shed and isinstance(rs[2].error, S.E.ShedError)
        assert rt.stats["shed_quota"] == 1
        vc.t += 1.0
        rs.append(rt.submit(S.Request(prog_for(S, SPEC), env)))
        rs.append(rt.submit(S.Request(prog_for(S, SPEC), env, tenant="b")))
        assert rs[3].ok and rs[4].ok
        return [resp(r) for r in rs], state(S, rt, vc, svc)
    with_served(served, scenario)


def test_queue_depth_sheds_batch_tail(served):
    def scenario(S, svc, env):
        rt, _ = make_runtime(S, svc, max_queue=2)
        rs = rt.submit_many(
            [S.Request(prog_for(S, SPEC), env) for _ in range(4)])
        assert [r.ok for r in rs] == [True, True, False, False]
        assert all(r.shed for r in rs[2:])
        assert rt.stats["shed_queue"] == 2
        return [resp(r) for r in rs], state(S, rt, None, svc)
    with_served(served, scenario)


def test_cold_compile_budget_sheds_new_families(served):
    def scenario(S, svc, env):
        rt, _ = make_runtime(S, svc, compile_budget=0)
        first = rt.submit(S.Request(prog_for(S, SPEC), env))
        assert first.ok
        r = rt.submit(S.Request(prog_for(S, dict(SPEC, shape="nested_map")),
                                env))
        assert not r.ok and r.shed and isinstance(r.error, S.E.ShedError)
        assert rt.stats["shed_compile"] == 1
        return [resp(first), resp(r)], state(S, rt)
    with_served(served, scenario)


# ---------------------------------------------------------------------------
# deadlines, retries, breaker
# ---------------------------------------------------------------------------

def test_retry_clears_transient_compile_fault(served):
    def scenario(S, svc, env):
        svc.evict()
        rt, vc = make_runtime(S, svc)
        S.FAULTS.arm("codegen.compile", "fail", first=0, count=1)
        r = rt.submit(S.Request(prog_for(S, SPEC), env))
        assert r.ok and r.retries == 1
        assert S.FAULTS.stats == {"codegen.compile:fail": 1}
        assert len(vc.slept) == 1
        return resp(r), state(S, rt, vc, svc)
    with_served(served, scenario)


def test_backoff_grows_exponentially_with_jitter(served):
    def scenario(S, svc, env):
        svc.evict()
        rt, vc = make_runtime(S, svc, max_retries=3, backoff_base=0.01,
                              backoff_cap=10.0)
        S.FAULTS.arm("codegen.compile", "fail", first=0, count=3)
        r = rt.submit(S.Request(prog_for(S, SPEC), env))
        assert r.ok and r.retries == 3
        assert len(vc.slept) == 3
        for k, d in enumerate(vc.slept, start=1):
            lo, hi = 0.005 * 2 ** (k - 1), 0.01 * 2 ** (k - 1)
            assert lo <= d <= hi, (k, d)
        return resp(r), state(S, rt, vc, svc)
    with_served(served, scenario)


def test_deadline_bounds_retries(served):
    def scenario(S, svc, env):
        svc.evict()
        rt, vc = make_runtime(S, svc, max_retries=50, backoff_base=0.1,
                              backoff_cap=0.1)
        S.FAULTS.arm("codegen.compile", "fail", first=0, count=-1)
        r = rt.submit(S.Request(prog_for(S, SPEC), env, deadline=0.25))
        assert not r.ok and isinstance(r.error, S.E.DeadlineExceeded)
        assert rt.stats["deadline_exceeded"] == 1
        assert vc.t <= 0.25 + 1e-9
        return resp(r), state(S, rt, vc, svc), vc.t
    with_served(served, scenario)


def test_circuit_breaker_opens_and_probes(served):
    def scenario(S, svc, env):
        rt, vc = make_runtime(S, svc, max_retries=0, breaker_threshold=2,
                              breaker_cooldown=5.0)
        svc.evict()
        S.FAULTS.arm("codegen.compile", "fail", first=0, count=-1)
        rs = [rt.submit(S.Request(prog_for(S, SPEC), env)) for _ in range(3)]
        assert not rs[0].ok and not rs[1].ok
        assert rs[2].shed and isinstance(rs[2].error, S.E.CircuitOpenError)
        assert rt.stats["circuit_open"] == 1
        S.FAULTS.reset()
        vc.t += 5.0
        rs += [rt.submit(S.Request(prog_for(S, SPEC), env)) for _ in range(2)]
        assert rs[3].ok and rs[4].ok
        return [resp(r) for r in rs], state(S, rt, vc, svc)
    with_served(served, scenario)


# ---------------------------------------------------------------------------
# degradation: eviction mid-flight, stored re-scan
# ---------------------------------------------------------------------------

def test_injected_eviction_recompiles_transparently(served):
    def scenario(S, svc, env):
        rt, _ = make_runtime(S, svc)
        assert rt.submit(S.Request(prog_for(S, SPEC), env)).ok
        miss0 = svc.stats["misses"]
        S.FAULTS.arm("serve.cache_evict", "evict", first=0, count=1)
        r = rt.submit(S.Request(prog_for(S, SPEC), env))
        assert r.ok and r.retries == 0
        assert rt.stats["injected_evictions"] == 1
        assert svc.stats["misses"] == miss0 + 1
        return resp(r), state(S, rt, None, svc)
    with_served(served, scenario)


def test_stored_chunk_fault_rescans_without_skipping(tmp_path):
    def scenario(S):
        svc = service(S)
        cat = S.Storage(str(tmp_path / S.name), **S.dev)
        cat.writer("d", diff_types(S.N), chunk_rows=8).append(
            TD.gen_inputs(SPEC))
        ds = cat.open("d")
        rt, _ = make_runtime(S, svc, verify_reads=True)
        ref = rt.submit(S.Request(prog_for(S, SPEC), ds))
        assert ref.ok
        S.FAULTS.arm("storage.chunk", "torn", first=0, count=1, arg=0.5)
        r = rt.submit(S.Request(prog_for(S, SPEC), ds))
        assert r.ok and "no_skip_rescan" in r.degraded
        assert rt.stats["degraded_no_skip"] == 1
        rows = svc.unshred_stored(prog_for(S, SPEC), ds, r.outputs, "Q")
        rows_ref = svc.unshred_stored(prog_for(S, SPEC), ds, ref.outputs,
                                      "Q")
        assert TD.equal(rows, rows_ref)
        S.FAULTS.reset()
        S.FAULTS.arm("storage.chunk", "missing", first=0, count=-1)
        r2 = rt.submit(S.Request(prog_for(S, SPEC), ds))
        assert not r2.ok and isinstance(r2.error, S.E.MissingChunkError)
        return ([resp(x) for x in (ref, r, r2)], state(S, rt, None, svc),
                sorted(map(repr, rows)))
    both(scenario)


def test_corrupt_encoded_blob_fails_typed_not_server(tmp_path):
    spec = dict(SPEC, n_orders=40, sel=None)

    def scenario(S):
        svc = service(S)
        cat = S.Storage(str(tmp_path / S.name), **S.dev)
        inputs = TD.gen_inputs(spec)
        cat.writer("d", diff_types(S.N), chunk_rows=16).append(inputs)
        ds = cat.open("d")
        part = ds.parts["Ord__D_oparts"]
        i, col = next((i, col) for i, c in enumerate(part.meta.chunks)
                      for col in c.encodings)
        path = S.chunk_path(ds.dir, "Ord__D_oparts", col, i)
        with open(path, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            b = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([b[0] ^ 0xFF]))
        rt, _ = make_runtime(S, svc, verify_reads=True)
        r = rt.submit(S.Request(prog_for(S, spec), ds))
        assert not r.ok and isinstance(r.error, S.E.ChunkCorruptionError)
        cat.writer("clean", diff_types(S.N), chunk_rows=16).append(inputs)
        r2 = rt.submit(S.Request(prog_for(S, spec), cat.open("clean")))
        assert r2.ok
        return [resp(r), resp(r2)], (i, col), state(S, rt)
    both(scenario)


# ---------------------------------------------------------------------------
# crash-recoverable plan cache
# ---------------------------------------------------------------------------

def manifest_shape(entries: dict) -> list:
    """Entries by kind, recorded schema (dtype names without the
    package's prefix) and hint shape — not by family id."""
    out = []
    for e in entries.values():
        schema = [(name, cap, [(c, dt.replace("torch.", ""))
                               for c, dt in cols])
                  for name, cap, cols in e.get("schema", [])]
        out.append((e["kind"], schema, e["skew"]))
    return sorted(map(repr, out))


def test_manifest_warm_replay_zero_retrace(tmp_path, served):
    def scenario(S, svc, env):
        man = str(tmp_path / S.name / "plans" / "manifest.json")
        rt, _ = make_runtime(S, svc, manifest_path=man)
        svc.evict()
        assert rt.submit(S.Request(prog_for(S, SPEC), env)).ok
        assert len(rt.manifest.entries) == 1
        svc2 = service(S)
        rt2, _ = make_runtime(S, svc2, manifest_path=man)
        assert rt2.warm_replay() == 1
        S.CG.reset_trace_stats()
        r = rt2.submit(S.Request(prog_for(S, SPEC), env))
        assert r.ok and S.CG.TRACE_STATS.get("traces", 0) == 0
        r2 = rt2.submit(S.Request(prog_for(S, dict(SPEC, selc=3)), env))
        assert r2.ok and S.CG.TRACE_STATS.get("traces", 0) == 0
        rows = svc2.unshred(prog_for(S, SPEC), env, r.outputs, "Q")
        direct = S.I.eval_expr(build_query(S.N, SPEC), TD.gen_inputs(SPEC))
        assert TD.equal(rows, direct)
        return (manifest_shape(rt.manifest.entries), state(S, rt2, None, svc2),
                [resp(r), resp(r2)])
    with_served(served, scenario)


def test_warm_replay_builds_bags_of_the_recorded_dtypes(tmp_path):
    """The port records dtype names as ``str(torch dtype)``; its
    synthetic environment turns them back into those dtypes, on the
    runtime's device, and refuses a name that is not one."""
    import torch
    from repro_torch.serve.runtime import _synthetic_env
    env = _synthetic_env([["B", 8, [["a", "torch.int64"],
                                    ["b", "torch.float64"],
                                    ["c", "torch.bool"]]]], "cpu")
    bag = env["B"]
    assert {c: a.dtype for c, a in bag.data.items()} == {
        "a": torch.int64, "b": torch.float64, "c": torch.bool}
    assert bag.capacity == 8 and not bool(bag.valid.any())
    assert bag.valid.device.type == "cpu"
    with pytest.raises(ValueError, match="torch dtype"):
        _synthetic_env([["B", 8, [["a", "int64x"]]]], "cpu")


def test_manifest_corruption_only_costs_cold_compiles(tmp_path, served):
    def scenario(S, svc, env):
        man = str(tmp_path / f"{S.name}.json")
        with open(man, "w") as f:
            f.write("{torn")
        rt, _ = make_runtime(S, svc, manifest_path=man)
        assert rt.manifest.entries == {}
        assert rt.warm_replay() == 0
        r = rt.submit(S.Request(prog_for(S, SPEC), env))
        assert r.ok
        return resp(r), state(S, rt)
    with_served(served, scenario)


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------

def test_submit_many_coalesces_one_family(served):
    def scenario(S, svc, env):
        rt, _ = make_runtime(S, svc)
        specs = [dict(SPEC, selc=c) for c in (1, 2, 3)]
        rs = rt.submit_many([S.Request(prog_for(S, s), env) for s in specs])
        assert all(r.ok for r in rs)
        assert rt.stats["batches"] == 1 and rt.stats["coalesced"] == 3
        rows = []
        for s, r in zip(specs, rs):
            got = svc.unshred(prog_for(S, s), env, r.outputs, "Q")
            direct = S.I.eval_expr(build_query(S.N, s), TD.gen_inputs(SPEC))
            assert TD.equal(got, direct), s
            rows.append(sorted(map(repr, got)))
        return [resp(r) for r in rs], state(S, rt, None, svc), rows
    with_served(served, scenario)


def test_submit_never_raises(served):
    def scenario(S, svc, env):
        rt, _ = make_runtime(S, svc)
        bad = S.N.Program([S.N.Assignment(
            "Q", S.N.Var("NoSuchInput", diff_types(S.N)["Ord"]))])
        r = rt.submit(S.Request(bad, env))
        assert not r.ok and r.error is not None
        return resp(r), state(S, rt)
    with_served(served, scenario)


# ---------------------------------------------------------------------------
# recovery paths, bit for bit (the reference's slow tier, on fixed specs)
# ---------------------------------------------------------------------------

RECOVERY_SPECS = [TD.random_spec(np.random.RandomState(s)) for s in (3, 11)]


@pytest.mark.parametrize("spec", RECOVERY_SPECS,
                         ids=[s["shape"] for s in RECOVERY_SPECS])
def test_recovery_paths_bit_for_bit(spec, tmp_path):
    """The oracle answer, the answer after retry-on-transient-compile-
    fault, through the skip-disabled re-scan and after a mid-flight
    eviction: all equal, in both packages alike."""
    inputs = TD.gen_inputs(spec)

    def scenario(S):
        prog = prog_for(S, spec)
        direct = S.I.eval_expr(build_query(S.N, spec), inputs)
        svc = service(S)
        cat = S.Storage(str(tmp_path / S.name), **S.dev)
        cat.writer("d", diff_types(S.N), chunk_rows=8).append(inputs)
        ds = cat.open("d")
        rt, _ = make_runtime(S, svc, verify_reads=True)
        out = []
        for site, kind, kw in (("codegen.compile", "fail", {}),
                               ("storage.chunk", "torn", {"arg": 0.5}),
                               ("serve.cache_evict", "evict", {})):
            S.FAULTS.reset(0)
            S.FAULTS.arm(site, kind, first=0, count=1, **kw)
            r = rt.submit(S.Request(prog, ds))
            assert r.ok, (spec, site, r.error)
            assert TD.equal(direct,
                            svc.unshred_stored(prog, ds, r.outputs, "Q"))
            out.append((resp(r), dict(S.FAULTS.stats)))
        assert out[0][0][3] == 1 and "no_skip_rescan" in out[1][0][4]
        return out, dict(rt.stats)
    both(scenario)


@pytest.mark.parametrize("seed", [20260807])
def test_dist_fallback_bit_for_bit(seed):
    """Exchange failures on the distributed path degrade to the
    single-device twin with the oracle's answer."""
    rng = np.random.RandomState(seed)
    specs = [TD.random_spec(rng) for _ in range(2)]

    def scenario(S):
        out = []
        mesh = S.mesh(1)
        for spec in specs:
            prog = prog_for(S, spec)
            inputs = TD.gen_inputs(spec)
            direct = S.I.eval_expr(build_query(S.N, spec), inputs)
            dsvc = service(S, mesh=mesh, dist_kwargs=dict(adaptive=True))
            lsvc = service(S)
            env = dsvc.shred_inputs(inputs, **S.dev)
            vc = VirtualClock()
            rt = S.Runtime(dsvc, local_fallback=lsvc, clock=vc.now,
                           sleep=vc.sleep, seed=1)
            S.FAULTS.reset(0)
            S.FAULTS.arm("dist.exchange", "fail", first=0, count=-1)
            r = rt.submit(S.Request(prog, env))
            fstats = dict(S.FAULTS.stats)
            S.FAULTS.reset()
            assert r.ok and "dist_to_local" in r.degraded, (spec, r.error)
            assert rt.stats["degraded_dist_local"] == 1
            assert TD.equal(direct, lsvc.unshred(prog, env, r.outputs, "Q"))
            out.append((resp(r), state(S, rt, vc), fstats))
        return out
    both(scenario)


# ---------------------------------------------------------------------------
# one request stream under the chaos schedule
# ---------------------------------------------------------------------------

CHAOS_ORDERS = 300
CHAOS_THRESHOLDS = [float(t) for t in np.linspace(1.0, 19.0, 8)]


def chaos_run(S, td: str) -> dict:
    """``benchmarks/serving.py``'s chaos run on one package: a stored
    runtime and a distributed one with its single-device twin under
    ``arm_chaos_schedule(0)``, then a restart that warm-replays the
    manifest. Returns what the run shows, in shared names."""
    types = qs_types(S.N)
    catalog = S.Catalog(unique_keys={"Part__F": ("pid",)})
    data = gen_data(CHAOS_ORDERS)
    S.Writer(td, "chaos", types, chunk_rows=64).write(data)
    dsdir = os.path.join(td, "chaos")
    manifest = os.path.join(td, "plans.json")

    def svc_(**kw):
        return S.Service(types, catalog=catalog, **kw)

    def rows(svc, env, out, th):
        return sorted(map(repr, svc.unshred(family(S.N, th), env, out, "Q")))

    S.FAULTS.reset()
    clean = svc_()
    clean_ds = S.Stored(dsdir, **S.dev)
    want = {th: rows(clean, clean_ds,
                     clean.execute_stored(family(S.N, th), clean_ds), th)
            for th in CHAOS_THRESHOLDS}
    env = clean.shred_inputs(data, **S.dev)
    want_local = {th: rows(clean, env, clean.execute(family(S.N, th), env),
                           th) for th in CHAOS_THRESHOLDS[:3]}

    S.SF.arm_chaos_schedule(0)
    with pytest.raises(S.E.FooterError):
        S.Stored(dsdir, **S.dev)
    ds = S.Stored(dsdir, **S.dev)
    svc = svc_()
    vc = VirtualClock()
    rt = S.Runtime(svc, manifest_path=manifest, seed=0, verify_reads=True,
                   clock=vc.now, sleep=vc.sleep, **S.dev)
    stored = [rt.submit(S.Request(family(S.N, th), ds))
              for th in CHAOS_THRESHOLDS]
    twin = svc_()
    rt_d = S.Runtime(svc_(mesh=S.mesh(1), dist_kwargs=dict(adaptive=True)),
                     local_fallback=twin, seed=0, clock=vc.now,
                     sleep=vc.sleep)
    dist = [rt_d.submit(S.Request(family(S.N, th), env))
            for th in CHAOS_THRESHOLDS[:3]]
    coverage = S.SF.chaos_coverage()
    fstats = dict(S.FAULTS.stats)
    S.FAULTS.reset()
    assert all(n > 0 for n in coverage.values()), coverage
    for th, r in zip(CHAOS_THRESHOLDS, stored):
        assert r.ok, (th, r.error)
        assert rows(svc, ds, r.outputs, th) == want[th], th
    for th, r in zip(CHAOS_THRESHOLDS, dist):
        assert r.ok, (th, r.error)
        assert rows(twin, env, r.outputs, th) == want_local[th], th
    assert rt_d.stats["degraded_imbalance"] >= 1

    svc2 = svc_()
    rt2 = S.Runtime(svc2, manifest_path=manifest, seed=0, **S.dev)
    replayed = rt2.warm_replay()
    assert replayed >= 1
    S.CG.reset_trace_stats()
    ds2 = S.Stored(dsdir, **S.dev)
    after = [rt2.submit(S.Request(family(S.N, th), ds2))
             for th in CHAOS_THRESHOLDS]
    assert all(r.ok for r in after)
    assert S.CG.TRACE_STATS.get("traces", 0) == 0
    return {"stored": [resp(r) for r in stored],
            "dist": [resp(r) for r in dist],
            "stats": dict(rt.stats), "dist_stats": dict(rt_d.stats),
            "faults": fstats,
            "coverage": {f"{s}:{k}": n for (s, k), n in coverage.items()},
            "slept": vc.slept, "manifest": manifest_shape(
                rt.manifest.entries),
            "replayed": replayed, "replay_stats": dict(rt2.stats)}


def test_chaos_schedule_stream_matches_reference():
    """The same request stream under ``arm_chaos_schedule(0)``: every
    one of the nine classes fires, no request escapes, every answer is
    the fault-free one, and the port's sequence of (ok, error class,
    retries, degradations), its ``stats``, ``FAULTS.stats`` and backoff
    sleeps equal the reference's."""
    got = []
    for S in SIDES:
        with tempfile.TemporaryDirectory() as td:
            got.append(chaos_run(S, td))
    ref, port = got
    assert port["coverage"] == ref["coverage"]
    assert sum(1 for n in port["coverage"].values() if n > 0) == 9
    for key in ("stored", "dist", "faults", "stats", "dist_stats", "slept",
                "manifest", "replayed", "replay_stats"):
        assert port[key] == ref[key], key
