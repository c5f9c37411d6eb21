"""The port's front end: it imports nothing of JAX or the reference, and
its copies of NRC, shredding, materialization, unnesting and the plan
passes print the reference's materialized programs and plans."""

import os
import re
import subprocess
import sys

import pytest

from repro.core import codegen as RCG
from repro.core import materialization as RM
from repro.core import nrc as RN
from repro.core.unnesting import Catalog as RCatalog
from repro_torch.core import codegen as TCG
from repro_torch.core import materialization as TM
from repro_torch.core import nrc as TN
from repro_torch.core.unnesting import Catalog as TCatalog
from repro_torch.obs import reset_telemetry

from test_torch_queries import (diff_catalog, diff_types, fresh_start,
                                flat_to_nested_query, nested_to_flat_query,
                                nested_to_nested_query, quickstart,
                                tpch_catalog, tpch_types, build_query)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'src')!r})\n"
        "import repro_torch, repro_torch.core.codegen, repro_torch.exec.ops\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.storage, repro_torch.serve\n"
        "import repro_torch.core.skew, repro_torch.storage.morsel\n"
        "import repro_torch.exec.dist, repro_torch.core.cost\n"
        "import repro_torch.kernels.shuffle_pack\n"
        "import repro_torch.kernels.segment_reduce, repro_torch.data\n"
        "import repro_torch.data.generators, repro_torch.figures\n"
        "import repro_torch.figures.common, repro_torch.figures.tpch_nested\n"
        "import repro_torch.figures.biomedical\n"
        "import repro_torch.figures.succinct\n"
        "import repro_torch.figures.representation\n"
        "import repro_torch.models.transformer, repro_torch.serve.engine\n"
        "import repro_torch.configs, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.rwkv6_scan\n"
        "import repro_torch.configs.gemma2_27b, repro_torch.configs.rwkv6_7b\n"
        "import repro_torch.obs.explain, repro_torch.obs.feedback\n"
        "import repro_torch.serve.runtime, repro_torch.serve.faults\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)


def test_port_sources_import_no_jax_and_no_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src",
                                                  "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            hits = _IMPORT.findall(fh.read())
        assert not hits, (f, hits)


# ---------------------------------------------------------------------------
# materialized programs and compiled plans print the same text
# ---------------------------------------------------------------------------

def _texts(N, M, CG, Catalog, build, types, catalog_of, de):
    fresh_start(N, value=100)
    q = build(N)
    sp = M.shred_program(N.Program([N.Assignment("Q", q)]), types(N),
                         domain_elimination=de)
    cp = CG.compile_program(sp, catalog_of(Catalog))
    return N.pretty_program(sp.program), cp.pretty(), cp.graph.pretty()


def _assert_same_texts(build, types, catalog_of):
    for de in (True, False):
        want = _texts(RN, RM, RCG, RCatalog, build, types, catalog_of, de)
        got = _texts(TN, TM, TCG, TCatalog, build, types, catalog_of, de)
        for w, g in zip(want, got):
            assert g == w, (de, w, g)


def test_quickstart_texts_match_reference():
    _assert_same_texts(lambda N: quickstart(N)[0],
                       lambda N: quickstart(N)[1],
                       lambda C: C(unique_keys={"Part__F": ("pid",)}))


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_tpch_texts_match_reference(levels):
    _assert_same_texts(lambda N: flat_to_nested_query(N, levels),
                       tpch_types, tpch_catalog)

    def n_types(N):
        return {"NCOP": flat_to_nested_query(N, levels).ty,
                "Part": tpch_types(N)["Part"]}

    _assert_same_texts(
        lambda N: nested_to_nested_query(
            N, levels, "NCOP", flat_to_nested_query(N, levels).ty),
        n_types, tpch_catalog)
    _assert_same_texts(
        lambda N: nested_to_flat_query(
            N, levels, "NCOP", flat_to_nested_query(N, levels).ty),
        n_types, tpch_catalog)


@pytest.mark.parametrize("shape", ["nested_agg", "flat_agg", "nested_map",
                                   "nested_join_plain"])
def test_differential_texts_match_reference(shape):
    spec = dict(seed=1, n_orders=5, n_parts=4, zipf=0.0, shape=shape,
                sel="qty_ge", selc=2)
    _assert_same_texts(lambda N: build_query(N, spec), diff_types,
                       diff_catalog)


def test_unported_passes_raise_naming_the_roadmap():
    """The passes that once waited for a later slice now run: the
    statistics-driven planning (item 4), distributed execution (item 5),
    and batched execution, the stats feedback loop and EXPLAIN ANALYZE
    (item 7)."""
    from repro_torch.core.plans import ExecSettings, ScanP, eval_plan
    from repro_torch.core.skew import TableStats
    from repro_torch.exec.dist import device_mesh_1d
    from repro_torch.obs import StatsFeedback
    from repro_torch.obs.explain import ExplainRecorder
    from repro_torch.serve import QueryService
    from test_torch_queries import QS_COP, QS_PARTS
    fresh_start(TN)
    q, types = quickstart(TN)
    sp = TM.shred_program(TN.Program([TN.Assignment("Q", q)]), types,
                          domain_elimination=True)
    TCG.compile_program(sp, skew_stats={"COP__F": TableStats(rows=8)})
    TCG.compile_program(sp, cost_mode="auto")
    QueryService(types, skew_partitions=8,
                 mesh=device_mesh_1d(8, device="cpu"))
    env = TCG.columnar_shred_inputs({"COP": QS_COP, "Part": QS_PARTS},
                                    types, device="cpu")
    prog = TN.Program([TN.Assignment("Q", q)])
    outs = QueryService(types).execute_many([prog, prog], env)
    assert len(outs) == 2 and "Q" in outs[0]
    fb = StatsFeedback()
    QueryService(types, feedback=fb).execute(prog, env)
    assert fb.observed_rows("COP__F") == 2
    rec = ExplainRecorder()
    bag = eval_plan(ScanP("COP__F", "c"), env, ExecSettings(explain=rec))
    assert [n.op for n in rec.roots] == ["ScanP"]
    assert rec.roots[0].rows_out == int(bag.valid.sum()) == 2
