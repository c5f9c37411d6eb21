"""The port's data generators and figure drivers against the
reference's: the generators give the reference's rows; the drivers of
``repro_torch.figures`` emit the rows of ``benchmarks/`` with the same
derived fields (``assignments=``, ``out_bytes=``, ``localized_leaf=``,
the biomedical ``steps=4;assignments=7;match=True``, the succinct
``x37.5``); their queries print the reference's text."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

from repro.core import codegen as RCG
from repro.core import materialization as RM
from repro.core import nrc as RN
from repro.core.materialization import mat_input_name as r_mat_input_name
from repro.core.unnesting import compile_standard as r_compile_standard
from repro.data import generators as RG
from repro_torch.core import nrc as TN
from repro_torch.data import generators as TG
from repro_torch.figures import biomedical as FB
from repro_torch.figures import common as FC
from repro_torch.figures import representation as FR
from repro_torch.figures import succinct as FS
from repro_torch.figures import tpch_nested as FT
from repro_torch.obs import reset_telemetry

from test_torch_queries import fresh_start

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SCALE = 40


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


def _fields(rows) -> dict:
    """{row name: derived field} of ``name,us_per_call,derived`` rows."""
    out = {}
    for r in rows:
        name, _, derived = r.split(",", 2)
        out[name] = derived
    return out


def _ref_rows(monkeypatch, run, module, **kw) -> list:
    """The rows a reference driver prints, each timing cut to one call
    (its derived fields do not depend on the timing)."""
    monkeypatch.setattr(module, "time_fn",
                        lambda fn, warmup=1, iters=3: (fn(), 1.0)[1],
                        raising=False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(**kw)
    return buf.getvalue().strip().splitlines()


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def test_schemas_match_reference():
    for port, ref in ((TG.TPCH_TYPES, RG.TPCH_TYPES),
                      (TG.BIO_TYPES, RG.BIO_TYPES),
                      (TG.CORPUS_TYPES, RG.CORPUS_TYPES)):
        assert list(port) == list(ref)
        for name in ref:
            assert repr(port[name]) == repr(ref[name]), name


@pytest.mark.parametrize("skew", [0.0, 1.2])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generators_give_the_reference_rows(seed, skew):
    assert TG.gen_tpch(scale=30, skew=skew, seed=seed) == \
        RG.gen_tpch(scale=30, skew=skew, seed=seed)
    assert TG.gen_biomedical(n_samples=6, n_genes=15, skew=skew,
                             seed=seed) == \
        RG.gen_biomedical(n_samples=6, n_genes=15, skew=skew, seed=seed)
    assert TG.gen_corpus(n_docs=6, max_toks=16, skew=skew + 0.5,
                         seed=seed) == \
        RG.gen_corpus(n_docs=6, max_toks=16, skew=skew + 0.5, seed=seed)
    a = TG.zipf_choice(np.random.RandomState(seed), 50, skew, 100)
    b = RG.zipf_choice(np.random.RandomState(seed), 50, skew, 100)
    assert a.tolist() == b.tolist()


# ---------------------------------------------------------------------------
# query builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [1, 2, 3])
def test_tpch_builders_print_the_reference_text(levels):
    import benchmarks.common as BC
    for build_ref, build_port in (
            (lambda: BC.flat_to_nested_query(levels),
             lambda N: FC.flat_to_nested_query(levels, N)),
            (lambda: BC.nested_to_nested_query(
                levels, "NCOP", BC.flat_to_nested_query(levels).ty),
             lambda N: FC.nested_to_nested_query(
                 levels, "NCOP", FC.flat_to_nested_query(levels, N).ty, N)),
            (lambda: BC.nested_to_flat_query(
                levels, "NCOP", BC.flat_to_nested_query(levels).ty),
             lambda N: FC.nested_to_flat_query(
                 levels, "NCOP", FC.flat_to_nested_query(levels, N).ty,
                 N))):
        fresh_start(RN, TN)
        want = RN.pretty(build_ref())
        fresh_start(RN, TN)
        assert RN.pretty(build_port(RN)) == want
        fresh_start(RN, TN)
        assert TN.pretty(build_port(TN)) == want
    assert FC.LEVEL_KEYS == BC.LEVEL_KEYS
    assert FC.CATALOG.unique_keys == BC.CATALOG.unique_keys


def test_run_shred_columnar_matches_reference():
    """``run_shred_columnar`` runs f2n level 2 over the same inputs to the
    reference's env, bit for bit."""
    import benchmarks.common as BC
    from test_torch_env import assert_env_parity
    db = TG.gen_tpch(scale=SCALE, skew=0.0, seed=0)
    fresh_start(RN, TN)
    rq = BC.flat_to_nested_query(2)
    _, rrun = BC.run_shred_columnar(RN.Program([RN.Assignment("Q", rq)]),
                                    RG.TPCH_TYPES, db)
    fresh_start(RN, TN)
    tq = FC.flat_to_nested_query(2)
    _, trun = FC.run_shred_columnar(TN.Program([TN.Assignment("Q", tq)]),
                                    TG.TPCH_TYPES, db, device="cpu")
    assert_env_parity(rrun(), trun())


def test_biomedical_pipeline_prints_the_reference_text():
    import benchmarks.biomedical as BB
    fresh_start(RN, TN)
    want = RN.pretty_program(BB.build_pipeline())
    fresh_start(RN, TN)
    assert TN.pretty_program(FB.build_pipeline()) == want
    assert FB.CATALOG.unique_keys == BB.CATALOG.unique_keys


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fig7_rows():
    with contextlib.redirect_stdout(io.StringIO()):
        return _fields(FT.run(scale=SCALE, device="cpu"))


def _ref_out_bytes(levels: int) -> int:
    """The reference's ``out_bytes=`` of f2n at ``levels``: the bytes of
    its standard route's parts."""
    import benchmarks.common as BC
    q = BC.flat_to_nested_query(levels)
    splan = r_compile_standard(q, input_roots={},
                               flat_inputs=dict(RG.TPCH_TYPES),
                               parts_name=r_mat_input_name,
                               catalog=BC.CATALOG)
    db = RG.gen_tpch(scale=SCALE, skew=0.0, seed=0)
    env = RCG.columnar_shred_inputs(db, RG.TPCH_TYPES)
    return sum(BC.bag_bytes(b) for b in RCG.run_standard(splan, env).values())


def _ref_program_names(family: str, levels: int) -> list:
    import benchmarks.common as BC
    if family == "f2n":
        q, types = BC.flat_to_nested_query(levels), dict(RG.TPCH_TYPES)
    else:
        nty = BC.flat_to_nested_query(levels).ty
        q = BC.nested_to_nested_query(levels, f"NCOP{levels}", nty)
        types = {**RG.TPCH_TYPES, f"NCOP{levels}": nty}
    sp = RM.shred_program(RN.Program([RN.Assignment("Q", q)]), types,
                          domain_elimination=True)
    return sp.program.names()


@pytest.mark.parametrize("family", ["f2n", "n2n", "n2f"])
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_fig7_rows_and_derived_fields_match_reference(fig7_rows, family,
                                                      levels):
    names = {"f2n": ("shred", "standard", "unshred_extra"),
             "n2n": ("shred", "standard"), "n2f": ("shred", "standard")}
    for kind in names[family]:
        assert f"{family}_L{levels}_{kind}" in fig7_rows
    got = {k: v for k, v in fig7_rows.items()
           if k.startswith(f"{family}_L{levels}_")}
    if family == "f2n":
        want = {f"f2n_L{levels}_shred":
                f"assignments={len(_ref_program_names('f2n', levels))}",
                f"f2n_L{levels}_standard":
                f"out_bytes={_ref_out_bytes(levels)}",
                f"f2n_L{levels}_unshred_extra": ""}
    elif family == "n2n":
        leaf = [n for n in _ref_program_names("n2n", levels)
                if "oparts" in n][-1]
        want = {f"n2n_L{levels}_shred": f"localized_leaf={leaf}",
                f"n2n_L{levels}_standard": ""}
    else:
        want = {f"n2f_L{levels}_shred": "", f"n2f_L{levels}_standard": ""}
    assert got == want
    assert len(fig7_rows) == 21


def test_fig7_published_fields(fig7_rows):
    """The numbers the reference's driver prints at scale 40 (the n2f
    cross-check against the interpreter runs inside the driver)."""
    rows = fig7_rows
    assert [rows[f"f2n_L{lv}_standard"] for lv in (1, 2, 3)] == \
        ["out_bytes=5640", "out_bytes=9024", "out_bytes=12408"]
    assert [rows[f"f2n_L{lv}_shred"] for lv in (1, 2, 3)] == \
        ["assignments=2", "assignments=3", "assignments=4"]


def test_biomedical_rows_match_reference():
    """The port's rows, and the derived field the reference's driver
    prints: its assignment count from the reference's own shredding (its
    ``match=True`` is the driver's oracle check, which the port's driver
    makes too)."""
    import benchmarks.biomedical as BB
    sp = RM.shred_program(BB.build_pipeline(), RG.BIO_TYPES,
                          domain_elimination=True)
    with contextlib.redirect_stdout(io.StringIO()):
        got = _fields(FB.run(device="cpu"))
    assert got == {"bio_e2e_shred": f"steps=4;assignments="
                                    f"{len(sp.program.names())};match=True",
                   "bio_e2e_interpreter": ""}
    assert got["bio_e2e_shred"] == "steps=4;assignments=7;match=True"


def test_succinct_rows_match_reference(monkeypatch):
    import benchmarks.succinct as BS
    want = _ref_rows(monkeypatch, BS.run, BS)
    with contextlib.redirect_stdout(io.StringIO()):
        got = FS.run()
    assert got == want
    assert got[-1] == "succinct_sharing_ratio,0.0,x37.5"
    assert repr(FS.MUT_T) == repr(BS.MUT_T)


def test_representation_rows_match_reference(monkeypatch):
    import benchmarks.representation as BR
    want = _fields(_ref_rows(monkeypatch, BR.run, BR, n=2000, groups=64))
    with contextlib.redirect_stdout(io.StringIO()):
        got = _fields(FR.run(n=2000, groups=64, device="cpu"))
    assert got["repr_rowwise_sumby"] == want["repr_rowwise_sumby"] \
        == "n=2000"
    assert got["repr_segment_reduce_kernel_matches"] == \
        want["repr_segment_reduce_pallas_interp_matches"] == "True"
    assert set(got) == {"repr_rowwise_sumby", "repr_columnar_sumby",
                        "repr_segment_reduce_plain",
                        "repr_segment_reduce_kernel",
                        "repr_segment_reduce_kernel_matches"}


# ---------------------------------------------------------------------------
# the card phases' bulk builders (chip_smoke.py phases H and I)
# ---------------------------------------------------------------------------

def _tpch_rows(t) -> dict:
    """The tables of ``chip_smoke.tpch_hierarchy`` as gen_tpch's rows."""
    def rows(**cols):
        names = list(cols)
        return [dict(zip(names, (v.item() for v in vals)))
                for vals in zip(*cols.values())]
    n_orders, n_cust = t["ord_cid"].size, t["cust_cname"].size
    return {
        "Part": rows(pid=t["part_pid"], pname=t["part_pname"],
                     price=t["part_price"]),
        "Lineitem": rows(oid=t["li_oid"], pid=t["li_pid"], qty=t["li_qty"]),
        "Orders": rows(oid=np.arange(1, n_orders + 1), cid=t["ord_cid"],
                       odate=t["ord_odate"]),
        "Customer": rows(cid=np.arange(1, n_cust + 1), nid=t["cust_nid"],
                         cname=t["cust_cname"]),
        "Nation": rows(nid=t["nat_nid"], rid=t["nat_rid"],
                       nname=t["nat_nname"])}


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_card_nested_inputs_equal_the_interpreters_shredding(levels):
    """``chip_smoke.shred_nested`` gives the parts that value-shredding
    f2n's answer gives (same labels, same row order), and
    ``fig7_flat`` the flat tables, so phase H runs Fig. 7 on the value
    the reference's driver builds."""
    import chip_smoke
    from repro_torch.columnar.table import env_to_numpy
    from repro_torch.core import codegen as TCG
    from test_torch_env import assert_np_bag_equal
    t = chip_smoke.tpch_hierarchy(chip_smoke.gen_tpch_columns(300, 5), 5)
    db = _tpch_rows(t)
    nested, nty = FC.materialize_nested_input(db, levels)
    name = f"NCOP{levels}"
    want = env_to_numpy(TCG.columnar_shred_inputs({name: nested},
                                                  {name: nty}, device="cpu"))
    got = chip_smoke.shred_nested(t, levels)
    assert sorted(got) == sorted(want)
    for part in want:
        assert list(got[part][0]) == list(want[part][0]), part
        assert_np_bag_equal(want[part], got[part], part)
    flat_want = env_to_numpy(TCG.columnar_shred_inputs(
        db, {k: TG.TPCH_TYPES[k] for k in db}, device="cpu"))
    flat_got = chip_smoke.fig7_flat(t)
    for part, bag in flat_got.items():
        assert_np_bag_equal(flat_want[part], bag, part)


def test_card_biomedical_inputs_have_the_shredded_schema():
    """``chip_smoke.gen_bio_shredded`` gives the parts, columns and dtypes
    that value-shredding ``gen_biomedical``'s rows gives, with labels
    that point at existing parent rows."""
    import chip_smoke
    from repro_torch.columnar.table import env_to_numpy
    from repro_torch.core import codegen as TCG
    want = env_to_numpy(TCG.columnar_shred_inputs(
        TG.gen_biomedical(n_samples=4, n_genes=9), TG.BIO_TYPES,
        device="cpu"))
    got = chip_smoke.gen_bio_shredded(4, 9, seed=0)
    assert sorted(got) == sorted(want)
    for part in want:
        assert list(got[part][0]) == list(want[part][0]), part
        for c, a in want[part][0].items():
            assert got[part][0][c].dtype == a.dtype, (part, c)
    for child, parent, col in (
            ("Occurrences__D_candidates", "Occurrences__F", "candidates"),
            ("Occurrences__D_candidates_consequences",
             "Occurrences__D_candidates", "consequences"),
            ("Network__D_edges", "Network__F", "edges")):
        labels = got[child][0]["label"]
        assert np.isin(labels, got[parent][0][col]).all()
        assert (np.diff(labels) >= 0).all()
    assert got["CopyNumber__F"][1].size == 4 * 9
