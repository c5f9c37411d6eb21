"""The port's EXPLAIN ANALYZE and stats feedback against the reference's,
on the CPU.

The cases of ``tests/test_obs.py``'s explain and feedback sections, run
through both packages on the same seeded inputs: explain trees
(``op``, ``label``, ``rows_out``, ``rows_in``, ``est_rows``, ``sig``,
``sites`` and every meter; wall times aside) equal node for node on the
local, storage-backed and 8-site distributed paths, with bit-equal
outputs and the same ``pretty()`` operators; ``StatsFeedback``'s
dicts, its saved JSON and a rewritten dataset footer equal byte for
byte. The reference's distributed half runs in one subprocess on 8
virtual XLA devices (set before JAX starts, as ``tests/test_dist.py``
does); the port runs the same case on an 8-site virtual mesh on the
CPU.
"""

import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from repro.core import codegen as RCG
from repro.core import nrc as RN
from repro.core.skew import TableStats as RTableStats
from repro.core.skew import decide_heavy_keys as r_decide
from repro.core.unnesting import Catalog as RCatalog
from repro.obs import StatsFeedback as RFeedback
from repro.obs import explain_analyze as r_explain
from repro.obs import record_observed_stats as r_record_stats
from repro.serve import QueryService as RService
from repro.storage import StorageCatalog as RStorage
from repro_torch.core import codegen as TCG
from repro_torch.core import nrc as TN
from repro_torch.core.skew import TableStats as TTableStats
from repro_torch.core.skew import decide_heavy_keys as t_decide
from repro_torch.core.unnesting import Catalog as TCatalog
from repro_torch.obs import StatsFeedback as TFeedback
from repro_torch.obs import explain_analyze as t_explain
from repro_torch.obs import record_observed_stats as t_record_stats
from repro_torch.obs import reset_telemetry
from repro_torch.serve import QueryService as TService
from repro_torch.storage import StorageCatalog as TStorage

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
sys.path.insert(0, os.path.join(TESTS, ".."))
PN = 8

from chip_smoke import explain_tree as tree  # noqa: E402
from helpers import gen_cop, gen_parts  # noqa: E402
from test_torch_env import (CPU, assert_env_parity,  # noqa: E402
                            assert_np_bag_equal, port_env)
from test_torch_queries import (build_query, diff_catalog,  # noqa: E402
                                diff_types, fresh_start, quickstart)


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


# ---------------------------------------------------------------------------
# inputs, built by each package from one text
# ---------------------------------------------------------------------------

def running(N):
    """(program, input types) of the running example."""
    fresh_start(N)
    q, types = quickstart(N)
    return N.Program([N.Assignment("Q", q)]), types


def running_rows():
    return {"Part": gen_parts(n=20, seed=0),
            "COP": gen_cop(6, 3, 4, 20, seed=1)}


def ref_env():
    _, types = running(RN)
    return RCG.columnar_shred_inputs(running_rows(), types)


def skewed_rows():
    """``benchmarks/obs.py``'s distributed input: pid 7 takes about 70%
    of the lineitems."""
    rng = np.random.RandomState(0)
    parts = [{"pid": i, "pname": 100 + i, "price": float(rng.randint(1, 20))}
             for i in range(1, 21)]
    cop = []
    for c in range(8):
        orders = []
        for o in range(rng.randint(1, 4)):
            items = [{"pid": 7 if rng.rand() < 0.7
                      else int(rng.randint(1, 21)),
                      "qty": float(rng.randint(1, 5))}
                     for _ in range(rng.randint(1, 6))]
            orders.append({"odate": 20200000 + o, "oparts": items})
        cop.append({"cname": 1000 + c, "corders": orders})
    return {"COP": cop, "Part": parts}


def padded(env, m=PN):
    return {k: b.resize(-(-b.capacity // m) * m) for k, b in env.items()}


def skew_stats(TableStats):
    return {"COP__D_corders_oparts":
            TableStats(rows=200, heavy={"pid": [(7, 120)]})}


# ---------------------------------------------------------------------------
# comparing explain results
# ---------------------------------------------------------------------------

def pretty_ops(text: str) -> list:
    """``pretty()``'s operator lines without the header and the times."""
    return [re.sub(r" (trace_)?ms=[0-9.]+", "", line)
            for line in text.split("\n")[1:]]


def assert_same_explain(ref, port) -> None:
    assert ref.distributed == port.distributed
    assert tree(ref) == tree(port)
    assert pretty_ops(ref.pretty()) == pretty_ops(port.pretty())
    assert ref.qerror_summary() == port.qerror_summary()
    assert sorted(ref.outputs) == sorted(port.outputs)
    assert_env_parity(ref.outputs, port.outputs)


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE, local
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cost_mode", ["off", "auto"])
def test_explain_analyze_local_matches_reference(cost_mode):
    """test_obs.py::test_explain_analyze_local_annotations on both
    packages (and with the cost planner's estimates)."""
    env_r = ref_env()
    prog_r, types_r = running(RN)
    ref = r_explain(prog_r, env_r, types_r, cost_mode=cost_mode)
    prog_t, types_t = running(TN)
    port = t_explain(prog_t, port_env(env_r), types_t, cost_mode=cost_mode)
    assert not port.distributed and port.total_ms > 0
    scans = [n for n in port.nodes() if "Scan" in n.op]
    gammas = port.find("SumAggP") + port.find("GroupAggP")
    assert scans and gammas
    for node in port.nodes():
        assert node.rows_out is not None and node.wall_ms is not None
        if node.children:
            assert node.rows_in == sum(c.rows_out for c in node.children)
    text = port.pretty()
    assert "EXPLAIN ANALYZE" in text and "rows=" in text
    blob = port.to_json()
    assert blob["assignments"] and blob["assignments"][0]["plan"]["op"]
    if cost_mode == "auto":
        assert port.qerrors() and "est=" in text
    assert_same_explain(ref, port)


def test_explain_analyze_accepts_bare_expr_and_infers_types():
    env_r = ref_env()
    fresh_start(RN)
    ref = r_explain(quickstart(RN)[0], env_r)
    fresh_start(TN)
    port = t_explain(quickstart(TN)[0], port_env(env_r))
    assert any("Scan" in n.op for n in port.nodes()) and port.outputs
    assert_same_explain(ref, port)


def test_explain_analyze_shreds_row_inputs_on_the_device_asked():
    _, types_r = running(RN)
    ref = r_explain(running(RN)[0], running_rows(), types_r)
    prog_t, types_t = running(TN)
    port = t_explain(prog_t, running_rows(), types_t, device="cpu")
    assert all(b.valid.device == CPU for b in port.outputs.values())
    assert_same_explain(ref, port)


def test_feedback_round_lands_qerror_like_reference():
    """``benchmarks/cost.py``'s loop: estimate, measure, re-estimate from
    the observed per-operator rows; the same harvest and the same
    Q-errors in both packages, max at most 4 after one round."""
    env_r = ref_env()
    out = []
    for N, explain, Feedback, env, TableStats in (
            (RN, r_explain, RFeedback, env_r, RTableStats),
            (TN, t_explain, TFeedback, port_env(env_r), TTableStats)):
        prog, types = running(N)
        kw = dict(cost_mode="auto", skew_stats=skew_stats(TableStats),
                  skew_partitions=PN, hypercube_mode="off")
        r1 = explain(prog, env, types, **kw)
        fb = Feedback()
        harvested = fb.record_explain(r1)
        r2 = explain(prog, env, types, observed_rows=fb.node_rows, **kw)
        out.append((r1, r2, harvested, fb.to_json()))
    (ref1, ref2, ref_n, ref_fb), (port1, port2, port_n, port_fb) = out
    assert ref_n == port_n > 0 and ref_fb == port_fb
    assert_same_explain(ref1, port1)
    assert_same_explain(ref2, port2)
    assert port2.qerror_summary()["qerr_max"] <= 4.0


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE over a stored dataset
# ---------------------------------------------------------------------------

STORED_SPEC = dict(seed=3, n_orders=80, n_parts=5, zipf=0.0,
                   shape="flat_agg", sel="pid_le", selc=1)


def test_explain_analyze_stored_meters_match_reference(tmp_path):
    """Scans of a stored dataset load lazily: bytes read and decoded,
    chunks read and skipped, metered on each scan node, equal."""
    import test_differential as TD
    inputs = TD.gen_inputs(STORED_SPEC)
    out = []
    for N, C, Storage, explain, kw in (
            (RN, RCatalog, RStorage, r_explain, {}),
            (TN, TCatalog, TStorage, t_explain, {"device": "cpu"})):
        cat = Storage(str(tmp_path / ("port" if kw else "ref")), **kw)
        cat.writer("d", diff_types(N), chunk_rows=8,
                   encoding="auto").append(inputs)
        fresh_start(N, value=700)
        prog = N.Program([N.Assignment("Q", build_query(N, STORED_SPEC))])
        out.append(explain(prog, cat.open("d"), diff_types(N),
                           catalog=diff_catalog(C)))
    ref, port = out
    meters = [n.meters for n in port.nodes()]
    assert sum(m.get("storage.chunks_skipped", 0) for m in meters) > 0
    assert sum(m.get("storage.bytes_decoded", 0) for m in meters) > 0
    assert "chunks=" in port.pretty()
    assert_same_explain(ref, port)


def test_explain_analyze_refuses_a_stored_env_on_the_mesh(tmp_path):
    from repro_torch.exec.dist import device_mesh_1d
    import test_differential as TD
    cat = TStorage(str(tmp_path), device="cpu")
    cat.writer("d", diff_types(TN), chunk_rows=4).append(
        TD.gen_inputs(STORED_SPEC))
    fresh_start(TN, value=700)
    prog = TN.Program([TN.Assignment("Q", build_query(TN, STORED_SPEC))])
    with pytest.raises(ValueError, match="local-only"):
        t_explain(prog, cat.open("d"), diff_types(TN),
                  catalog=diff_catalog(TCatalog),
                  mesh=device_mesh_1d(PN, device="cpu"))


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE on 8 sites
# ---------------------------------------------------------------------------

def mesh_case(N, explain, CG, TableStats, mesh, env_kw):
    """``benchmarks/obs.py``'s distributed explain: the running example
    over skewed lineitems with a planned SkewJoinP, on ``mesh``."""
    prog, types = running(N)
    env = padded(CG.columnar_shred_inputs(skewed_rows(), types, **env_kw))
    return explain(prog, env, types, mesh=mesh,
                   skew_stats=skew_stats(TableStats), skew_partitions=PN)


_CHILD = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys, json
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
import numpy as np
import jax
from repro.core import codegen as CG
from repro.core import nrc as N
from repro.core.skew import TableStats
from repro.exec.dist import device_mesh_1d
from repro.obs import StatsFeedback, explain_analyze, reset_telemetry
import test_torch_obs as T
reset_telemetry()
res = T.mesh_case(N, explain_analyze, CG, TableStats,
                  device_mesh_1d(8), {{}})
fb = StatsFeedback()
ratio = fb.record_metrics("fam", res.metrics, 8)
arrays = {{}}
for name, bag in res.outputs.items():
    for c, a in bag.data.items():
        arrays[name + "/" + c] = np.asarray(a)
    arrays[name + "/__valid"] = np.asarray(bag.valid)
np.savez({npz!r}, **arrays)
with open({js!r}, "w") as f:
    json.dump({{"tree": T.tree(res), "pretty": T.pretty_ops(res.pretty()),
               "metrics": {{k: int(v) for k, v in res.metrics.items()}},
               "imbalance": ratio, "feedback": fb.to_json()}}, f)
print("OK")
"""


@pytest.fixture(scope="module")
def mesh_both():
    """(reference facts and outputs from the subprocess, port result)."""
    from repro_torch.exec.dist import device_mesh_1d
    with tempfile.TemporaryDirectory() as td:
        npz, js = os.path.join(td, "ref.npz"), os.path.join(td, "ref.json")
        script = _CHILD.format(src=os.path.abspath(SRC), tests=TESTS,
                               npz=npz, js=js)
        proc = subprocess.Popen([sys.executable, "-c", script],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        # the port runs while the reference subprocess compiles
        port = mesh_case(TN, t_explain, TCG, TTableStats,
                         device_mesh_1d(PN, device="cpu"),
                         {"device": "cpu"})
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"STDOUT:{out}\nSTDERR:{err}"
        with np.load(npz) as z:
            arrays = {k: z[k] for k in z.files}
        with open(js) as f:
            facts = json.load(f)
    return facts, arrays, port


def test_explain_analyze_mesh_matches_reference(mesh_both):
    facts, arrays, port = mesh_both
    assert port.distributed
    assert tree(port) == [tuple(t) for t in facts["tree"]]
    assert pretty_ops(port.pretty()) == facts["pretty"]
    assert {k: int(v) for k, v in port.metrics.items()} == facts["metrics"]
    skew = port.find("SkewJoinP") + port.find("MultiJoinP")
    assert skew and skew[0].rows_out > 0
    text = port.pretty()
    assert "imbalance=" in text and "shipped=" in text \
        and "trace_ms=" in text
    fb = TFeedback()
    assert fb.record_metrics("fam", port.metrics, PN) == facts["imbalance"]
    assert fb.to_json() == facts["feedback"]
    for name, bag in port.outputs.items():
        want = ({c: arrays[f"{name}/{c}"] for c in bag.data},
                arrays[f"{name}/__valid"])
        assert_np_bag_equal(want, ({c: a.numpy() for c, a in
                                    bag.data.items()}, bag.valid.numpy()),
                            name)


def test_explain_analyze_mesh_records_one_run_per_call(mesh_both):
    """A second call builds a tree of exactly one run of the program:
    the same tree, and each node once (each site numbers its operators
    on its own thread; only site 0's tree is kept), also with the
    interpreter switching threads as often as it can."""
    from repro_torch.exec.dist import device_mesh_1d
    _, _, first = mesh_both
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        again = mesh_case(TN, t_explain, TCG, TTableStats,
                          device_mesh_1d(PN, device="cpu"),
                          {"device": "cpu"})
    finally:
        sys.setswitchinterval(interval)
    assert tree(again) == tree(first)
    ids = [n.id for n in again.nodes()]
    assert ids == list(range(len(ids)))
    assert len(again.roots) == len(again.assignments) == len(again.outputs)


# ---------------------------------------------------------------------------
# feedback: measured rows into planner stats + footer round trip
# ---------------------------------------------------------------------------

def test_feedback_rows_flow_into_table_stats():
    env_r = ref_env()
    got = []
    for Feedback, TableStats, decide, env in (
            (RFeedback, RTableStats, r_decide, env_r),
            (TFeedback, TTableStats, t_decide, port_env(env_r))):
        fb = Feedback()
        fb.record_env(env)
        assert fb.observed_rows("COP__F") == 6
        stats = {"COP__F": TableStats(rows=4096)}
        fb.apply(stats)
        ts = stats["COP__F"]
        assert ts.effective_rows == 6 and ts.rows == 4096
        ts2 = TableStats(rows=1000, heavy={"k": [(7, 30)]},
                         meters={"rows": 100})
        with_meters = decide(ts2, "k", n_partitions=8)
        without = decide(TableStats(rows=1000, heavy={"k": [(7, 30)]}),
                         "k", n_partitions=8)
        assert with_meters == [7] and without == []
        got.append(fb.to_json())
    assert got[0] == got[1]


def test_feedback_imbalance_monotone_and_serializable(tmp_path):
    blobs = []
    for Feedback, tag in ((RFeedback, "ref"), (TFeedback, "port")):
        fb = Feedback()
        ratio = fb.record_metrics("fam", {"part_max_j0": 30,
                                          "part_rows_j0": 60}, 4)
        assert ratio == pytest.approx(2.0)
        fb.record_metrics("fam", {"part_max_j0": 15, "part_rows_j0": 60}, 4)
        assert fb.imbalance_x100["fam"] == 200      # max, not latest
        fb.rows["X"] = 11
        fb.node_rows["abc"] = 5
        p = str(tmp_path / f"{tag}.json")
        fb.save(p)
        back = Feedback.load(p)
        assert back.to_json() == fb.to_json()
        with open(p, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]


def test_observed_stats_footer_round_trip_matches_reference(tmp_path):
    """The rewritten footers are byte-identical, and the reopened
    dataset surfaces the meters through ``TableStats.meters``."""
    from repro.storage.format import FOOTER as RFOOTER
    footers = []
    for Storage, record, types, kw in (
            (RStorage, r_record_stats, running(RN)[1], {}),
            (TStorage, t_record_stats, running(TN)[1], {"device": "cpu"})):
        cat = Storage(str(tmp_path / ("port" if kw else "ref")), **kw)
        ds = cat.write("shop", running_rows(), types)
        part = sorted(ds.parts)[0]
        est = ds.parts[part].stats().rows
        n = record(ds.dir, {part: {"rows": est + 5, "imbalance_x100": 250},
                            "no_such_part": {"rows": 1}})
        assert n == 1
        ts = cat.open("shop", refresh=True).parts[part].stats()
        assert ts.meters == {"rows": est + 5, "imbalance_x100": 250}
        assert ts.effective_rows == est + 5 and ts.rows == est
        with open(os.path.join(ds.dir, RFOOTER), "rb") as f:
            footers.append(f.read())
    assert footers[0] == footers[1]


def test_query_service_feedback_measures_on_cold_compile():
    env_r = ref_env()
    got = []
    for Service, Feedback, N, env in (
            (RService, RFeedback, RN, env_r),
            (TService, TFeedback, TN, port_env(env_r))):
        fb = Feedback()
        prog, types = running(N)
        svc = Service(types, feedback=fb, cost_mode="auto")
        out = svc.execute(prog, env)
        assert out and fb.observed_rows("COP__F") == 6
        rows_before = dict(fb.rows)
        svc.execute(prog, env)              # warm: no re-measurement
        assert fb.rows == rows_before
        got.append((fb.to_json(), dict(svc.stats), out))
    assert got[0][:2] == got[1][:2]
    assert_env_parity(got[0][2], got[1][2])
