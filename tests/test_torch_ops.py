"""The port's hashing and columnar operators against the reference's,
on the same bags: bit-equal outputs (valid everywhere, data at valid
rows, equal dtypes and capacities) and equal ``SORT_STATS``, under both
``use_kernel`` settings and both ``ORDER_AWARE`` settings.

With ``use_kernel=True`` the reference runs its jnp kernel oracles
(``repro.kernels.ops.USE_REF``); the port runs its plain versions (the
bags lie on the CPU). The Pallas kernels themselves are compared in
``test_torch_kernels.py`` and, once per kernel, in ``test_torch_slice.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.columnar.table import FlatBag as RBag
from repro.exec import hashing as RH
from repro.exec import ops as RX
from repro.kernels import ops as RK
from repro_torch.columnar.table import FlatBag as TBag
from repro_torch.exec import hashing as TH
from repro_torch.exec import ops as TX
from repro_torch.obs import reset_telemetry

from test_torch_env import assert_bag_parity
from test_torch_queries import FLOAT_KEY_VALUES


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


@pytest.fixture(autouse=True)
def _reference_kernel_oracles():
    prev = RK.USE_REF
    RK.USE_REF = True
    try:
        yield
    finally:
        RK.USE_REF = prev


@contextlib.contextmanager
def order_awareness(enabled: bool):
    with RX.order_awareness(enabled), TX.order_awareness(enabled):
        yield


def both(cols: dict, valid: np.ndarray):
    """The same bag in both packages (port on the CPU)."""
    ref = RBag({c: jnp.asarray(a) for c, a in cols.items()},
               jnp.asarray(valid))
    port = TBag({c: torch.from_numpy(np.array(a)) for c, a in cols.items()},
                torch.from_numpy(np.array(valid)))
    return ref, port


def assert_sort_stats_equal():
    assert dict(TX.SORT_STATS) == dict(RX.SORT_STATS), \
        (dict(TX.SORT_STATS), dict(RX.SORT_STATS))


def probe_bag(n=24, seed=0, invalid=0.25):
    rng = np.random.RandomState(seed)
    cols = {"k": rng.randint(0, 6, n).astype(np.int64),
            "g": rng.randint(-2, 3, n).astype(np.int64),
            "v": rng.randint(0, 9, n).astype(np.float64),
            "w": rng.randint(0, 5, n).astype(np.float32),
            "c": rng.randint(-4, 9, n).astype(np.int64),
            "s": rng.randint(0, 3, n).astype(np.int32),
            "b": rng.rand(n) < 0.5}
    return both(cols, rng.rand(n) >= invalid)


def build_bag(n=7, seed=1, dup=False):
    rng = np.random.RandomState(seed)
    k = np.arange(n, dtype=np.int64)
    if dup:
        k = np.sort(rng.randint(0, max(n // 2, 1), n)).astype(np.int64)
    rng.shuffle(k)
    cols = {"k": k, "rw": rng.randint(0, 50, n).astype(np.float64),
            "rs": rng.randint(0, 4, n).astype(np.int32)}
    valid = rng.rand(n) >= 0.2
    return both(cols, valid)


CONFIGS = [(uk, oa) for uk in (False, True) for oa in (True, False)]
IDS = [f"kernel={uk}-order_aware={oa}" for uk, oa in CONFIGS]


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

EDGE64 = np.array([0, 1, -1, np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                   2 ** 32, -2 ** 32, 0x9E3779B97F4A7C15 - 2 ** 64],
                  dtype=np.int64)


@pytest.mark.parametrize("seed", range(3))
def test_mix64_and_combine64_bit_equal(seed):
    rng = np.random.RandomState(seed)
    a = np.concatenate([EDGE64, rng.randint(-2 ** 63, 2 ** 63 - 1, 500,
                                            dtype=np.int64)])
    b = np.roll(a, 3)
    c = rng.randint(-5, 5, a.size).astype(np.int32)
    assert np.array_equal(np.asarray(RH.mix64(jnp.asarray(a))),
                          TH.mix64(torch.from_numpy(a)).numpy())
    for cols in ([a], [a, b], [a, b, c], [c, a],
                 [a, rng.rand(a.size) < 0.5]):
        want = np.asarray(RH.combine64([jnp.asarray(x) for x in cols]))
        got = TH.combine64([torch.from_numpy(np.array(x)) for x in cols])
        assert got.dtype == torch.int64
        assert np.array_equal(want, got.numpy())


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel,order_aware", CONFIGS, ids=IDS)
@pytest.mark.parametrize("keys,vals", [(("k",), ("v",)),
                                       (("g", "k"), ("v", "w", "c")),
                                       (("s", "b"), ("w",)),
                                       (("b",), ("c", "b"))])
def test_sum_by(use_kernel, order_aware, keys, vals):
    for seed in range(3):
        ref, port = probe_bag(seed=seed)
        with order_awareness(order_aware):
            want = RX.sum_by(ref, keys, vals, use_kernel=use_kernel)
            got = TX.sum_by(port, keys, vals, use_kernel=use_kernel)
            assert_bag_parity(want, got)
            # a prefix grouping reuses the delivered order
            want = RX.sum_by(want, keys[:1], vals[:1], use_kernel=use_kernel)
            got = TX.sum_by(got, keys[:1], vals[:1], use_kernel=use_kernel)
            assert_bag_parity(want, got)
        assert_sort_stats_equal()


@pytest.mark.parametrize("order_aware", [True, False])
@pytest.mark.parametrize("cols", [None, ("k",), ("g", "s"), ("b", "w")])
def test_dedup(order_aware, cols):
    for seed in range(3):
        ref, port = probe_bag(seed=seed)
        with order_awareness(order_aware):
            assert_bag_parity(RX.dedup(ref, cols), TX.dedup(port, cols))
    assert_sort_stats_equal()


@pytest.mark.parametrize("use_kernel,order_aware", CONFIGS, ids=IDS)
def test_nest_level(use_kernel, order_aware):
    for seed in range(3):
        ref, port = probe_bag(seed=seed)
        with order_awareness(order_aware):
            rp, rc = RX.nest_level(ref, ("g", "s"), ("k", "v"), "lbl",
                                   child_valid_col="b",
                                   use_kernel=use_kernel)
            tp, tc = TX.nest_level(port, ("g", "s"), ("k", "v"), "lbl",
                                   child_valid_col="b",
                                   use_kernel=use_kernel)
            assert_bag_parity(rp, tp, "parents")
            assert_bag_parity(rc, tc, "children")
    assert_sort_stats_equal()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_presorted_bag_with_interleaved_invalid_rows(use_kernel):
    """A bag that delivers ``sorted_by`` but not ``invalid_last`` (a
    masked sum_by output, say) is grouped without a sort: invalid rows,
    including a leading one whose key equals the first valid row's,
    fold into the running segment."""
    from repro.columnar.props import PhysicalProps as RProps
    from repro_torch.columnar.props import PhysicalProps as TProps
    k = np.array([2, 2, 2, 3, 3, 5, 5, 5, 7, 9], dtype=np.int64)
    v = np.arange(10, dtype=np.float64)
    for valid in ([0, 1, 1, 0, 1, 1, 0, 1, 0, 1],
                  [0, 0, 1, 1, 0, 0, 0, 1, 1, 0],
                  [1, 0, 0, 0, 0, 0, 0, 0, 0, 1]):
        ref, port = both({"k": k, "v": v}, np.array(valid, dtype=bool))
        ref = ref.with_props(RProps(sorted_by=("k",)))
        port = port.with_props(TProps(sorted_by=("k",)))
        assert_bag_parity(RX.sum_by(ref, ("k",), ("v",), use_kernel),
                          TX.sum_by(port, ("k",), ("v",), use_kernel))
        assert_bag_parity(RX.dedup(ref, ("k",)), TX.dedup(port, ("k",)))
        rp, rc = RX.nest_level(ref, ("k",), ("v",), "l",
                               use_kernel=use_kernel)
        tp, tc = TX.nest_level(port, ("k",), ("v",), "l",
                               use_kernel=use_kernel)
        assert_bag_parity(rp, tp)
        assert_bag_parity(rc, tc)
    assert TX.SORT_STATS.get("lexsort", 0) == 0
    assert_sort_stats_equal()


def test_lexsort_floats_by_bits():
    """Floats sort and group by bit pattern: -0.0 and 0.0 stay apart,
    bit-identical NaNs group together."""
    x = np.array([0.0, -0.0, np.nan, 1.5, -0.0, np.nan, -2.0, 0.0, 1.5],
                 dtype=np.float64)
    f = x.astype(np.float32)
    cols = {"x": x, "f": f, "i": np.arange(x.size, dtype=np.int64)}
    valid = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1], dtype=bool)
    ref, port = both(cols, valid)
    for keys in (("x",), ("f", "x"), ("x", "i")):
        want = RX._lexsort(ref, keys)
        got = TX._lexsort(port, keys)
        # the whole permutation, invalid rows included, is the same
        assert np.array_equal(np.asarray(want.data["i"]),
                              got.data["i"].numpy()), keys
        assert_bag_parity(want, got)
        assert np.array_equal(np.asarray(RX._presorted_seg_ids(want, keys)),
                              TX._presorted_seg_ids(got, keys).numpy())
    assert_bag_parity(RX.sum_by(ref, ("x",), ("f",)),
                      TX.sum_by(port, ("x",), ("f",)))
    assert_bag_parity(RX.dedup(ref, ("f",)), TX.dedup(port, ("f",)))
    assert_sort_stats_equal()


# ---------------------------------------------------------------------------
# joins and union
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel,order_aware", CONFIGS, ids=IDS)
@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_fk_join(use_kernel, order_aware, how):
    for seed in range(3):
        left, tleft = probe_bag(seed=seed)
        right, tright = build_bag(seed=seed)
        with order_awareness(order_aware):
            want = RX.fk_join(left, right, ("k",), ("k",), how=how,
                              use_kernel=use_kernel)
            got = TX.fk_join(tleft, tright, ("k",), ("k",), how=how,
                             use_kernel=use_kernel)
            assert_bag_parity(want, got)
            # the same build side again: its argsort is reused
            want = RX.fk_join(want.select_columns(["k", "g"]), right,
                              ("k",), ("k",), how=how, right_prefix="r_",
                              use_kernel=use_kernel)
            got = TX.fk_join(got.select_columns(["k", "g"]), tright,
                             ("k",), ("k",), how=how, right_prefix="r_",
                             use_kernel=use_kernel)
            assert_bag_parity(want, got)
    assert_sort_stats_equal()


@pytest.mark.parametrize("use_kernel,order_aware", CONFIGS, ids=IDS)
@pytest.mark.parametrize("how", ["inner", "left_outer"])
@pytest.mark.parametrize("out_capacity", [6, 40])
def test_general_join(use_kernel, order_aware, how, out_capacity):
    for seed in range(3):
        left, tleft = probe_bag(n=12, seed=seed)
        right, tright = build_bag(n=9, seed=seed, dup=True)
        with order_awareness(order_aware):
            want, wof = RX.general_join(left, right, ("k",), ("k",),
                                        out_capacity, how=how,
                                        matched_col="__m", rowid_col="rid",
                                        use_kernel=use_kernel)
            got, gof = TX.general_join(tleft, tright, ("k",), ("k",),
                                       out_capacity, how=how,
                                       matched_col="__m", rowid_col="rid",
                                       use_kernel=use_kernel)
            assert_bag_parity(want, got)
            assert gof.dtype == torch.int32 and np.asarray(wof).dtype == \
                np.int32
            assert int(gof) == int(wof)
            # multi-column keys go through combine64
            want, wof = RX.general_join(left, right, ("k", "s"),
                                        ("k", "rs"), out_capacity, how=how,
                                        use_kernel=use_kernel)
            got, gof = TX.general_join(tleft, tright, ("k", "s"),
                                       ("k", "rs"), out_capacity, how=how,
                                       use_kernel=use_kernel)
            assert_bag_parity(want, got)
            assert int(gof) == int(wof)
    assert_sort_stats_equal()


def test_general_join_reports_overflow():
    left, tleft = probe_bag(n=12, seed=0, invalid=0.0)
    right, tright = build_bag(n=9, seed=0, dup=True)
    _, wof = RX.general_join(left, right, ("k",), ("k",), 2)
    _, gof = TX.general_join(tleft, tright, ("k",), ("k",), 2)
    assert int(gof) == int(wof) > 0


def test_joins_with_every_row_invalid_and_tiny_sides():
    left, tleft = probe_bag(n=5, seed=2, invalid=1.1)       # all invalid
    right, tright = build_bag(n=1, seed=3)
    for uk in (False, True):
        assert_bag_parity(RX.fk_join(left, right, ("k",), ("k",),
                                     use_kernel=uk),
                          TX.fk_join(tleft, tright, ("k",), ("k",),
                                     use_kernel=uk))
        w, wof = RX.general_join(left, right, ("k",), ("k",), 3,
                                 how="left_outer", use_kernel=uk)
        g, gof = TX.general_join(tleft, tright, ("k",), ("k",), 3,
                                 how="left_outer", use_kernel=uk)
        assert_bag_parity(w, g)
        assert int(wof) == int(gof) == 0
        assert_bag_parity(RX.sum_by(left, ("k",), ("v",), use_kernel=uk),
                          TX.sum_by(tleft, ("k",), ("v",), use_kernel=uk))


# ---------------------------------------------------------------------------
# float key columns: the reference's XLA casts, astype(int64) on the first
# key column and astype(uint64) on the later ones (NaN to 0, saturating;
# uint64 also sends every negative value to 0)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_float_casts_and_combine64_match_xla(dtype):
    x = FLOAT_KEY_VALUES.astype(dtype)
    tx = torch.from_numpy(x)
    assert np.array_equal(TH.to_int64_like_xla(tx).numpy(),
                          np.asarray(jnp.asarray(x).astype(jnp.int64)))
    assert np.array_equal(
        TH.to_uint64_bits_like_xla(tx).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.uint64)).view(np.int64))
    i = np.arange(x.size, dtype=np.int64)
    for cols in ([x], [i, x], [x, i], [x, x[::-1].copy()]):
        want = np.asarray(RH.combine64([jnp.asarray(c) for c in cols]))
        got = TH.combine64([torch.from_numpy(c) for c in cols])
        assert np.array_equal(want, got.numpy())


def float_probe_bag():
    """Probe keys (k INT, x REAL, y REAL): NaN, -0.0, truncation (2.1 and
    2.9), negatives, out of the int64 range, and [2^63, 2^64)."""
    x = np.array([np.nan, -0.0, 2.1, -3.0, 1e300, -np.inf, np.inf, 2.0 ** 63,
                  -2.5, 9.0, 0.7, -2.9, 2.0 ** 63 + 4096.0, 1e30],
                 dtype=np.float64)
    y = np.array([-3.0, np.nan, 2.5, 2.0 ** 63 + 4096.0, 1e30, np.inf, -0.0,
                  -1e30, 9.9, 2.0 ** 64, 0.0, -5.0, 1.5 * 2.0 ** 63, 2.9],
                 dtype=np.float64)
    n = x.size
    cols = {"k": np.ones(n, np.int64), "x": x, "y": y,
            "v": np.arange(n, dtype=np.float64)}
    valid = np.ones(n, bool)
    valid[10] = False
    return both(cols, valid)


def float_build_bag():
    """Build keys, unique under the reference's casts of x alone and of
    (k, y): x to [0, 2, -3, INT64_MAX, INT64_MIN, 9], y to [0, 2,
    2^63 + 4096, all ones, 9, 2^63 * 1.5]."""
    x = np.array([0.5, 2.9, -3.0, 1e30, -1e30, 9.0], dtype=np.float64)
    y = np.array([-5.0, 2.0, 2.0 ** 63 + 4096.0, 7e29, 9.0, 1.5 * 2.0 ** 63],
                 dtype=np.float64)
    cols = {"k": np.ones(x.size, np.int64), "x": x, "y": y,
            "rw": np.arange(10, 10 + x.size, dtype=np.float64)}
    return both(cols, np.ones(x.size, bool))


FLOAT_KEYS = [(("x",), ("x",)), (("k", "y"), ("k", "y")),
              (("y", "x"), ("y", "x"))]


@pytest.mark.parametrize("use_kernel,order_aware", CONFIGS, ids=IDS)
@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_fk_join_on_float_keys(use_kernel, order_aware, how):
    left, tleft = float_probe_bag()
    right, tright = float_build_bag()
    with order_awareness(order_aware):
        for lk, rk in FLOAT_KEYS[:2]:
            want = RX.fk_join(left, right, lk, rk, how=how,
                              right_prefix="r_", use_kernel=use_kernel)
            got = TX.fk_join(tleft, tright, lk, rk, how=how,
                             right_prefix="r_", use_kernel=use_kernel)
            assert_bag_parity(want, got)
    assert_sort_stats_equal()


@pytest.mark.parametrize("use_kernel,order_aware", CONFIGS, ids=IDS)
@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_general_join_on_float_keys(use_kernel, order_aware, how):
    left, tleft = float_probe_bag()
    right, tright = float_build_bag()
    with order_awareness(order_aware):
        for lk, rk in FLOAT_KEYS:
            # the probe side against itself: many-to-many matches
            for r, tr in ((right, tright), (left, tleft)):
                want, wof = RX.general_join(left, r, lk, rk, 64, how=how,
                                            right_prefix="r_",
                                            use_kernel=use_kernel)
                got, gof = TX.general_join(tleft, tr, lk, rk, 64, how=how,
                                           right_prefix="r_",
                                           use_kernel=use_kernel)
                assert_bag_parity(want, got)
                assert int(gof) == int(wof)
    assert_sort_stats_equal()


def test_new_label_over_float_captures_matches_reference():
    """N.NewLabel casts every capture with astype(int64) before
    combine64 (so its later uint64 cast only reinterprets the bits)."""
    from repro.core import nrc as RN
    from repro.core.plans import eval_col_expr as r_eval
    from repro_torch.core import nrc as TN
    from repro_torch.core.plans import eval_col_expr as t_eval
    ref, port = float_probe_bag()

    def labels(N):
        k, x, y = N.Var("k", N.INT), N.Var("x", N.REAL), N.Var("y", N.REAL)
        return [N.NewLabel("L", (("a", x),)),
                N.NewLabel("L", (("a", k), ("b", y))),
                N.NewLabel("L", (("a", y), ("b", x), ("c", k)))]

    for re_, te in zip(labels(RN), labels(TN)):
        want = np.asarray(r_eval(re_, ref, None))
        got = t_eval(te, port, None).numpy()
        assert got.dtype == want.dtype == np.int64
        assert np.array_equal(got, want), RN.pretty(re_)


def test_union_all():
    a, ta = probe_bag(n=5, seed=4)
    b, tb = probe_bag(n=8, seed=5)
    assert_bag_parity(RX.union_all(a, b), TX.union_all(ta, tb))


# ---------------------------------------------------------------------------
# column expressions (plans.eval_col_expr): values and result dtypes
# ---------------------------------------------------------------------------

def _exprs(N):
    """Column expressions over probe_bag's columns, with constants and
    parameters of every kind: the dtype each gives must match."""
    V = {c: N.Var(c, t) for c, t in (("k", N.INT), ("v", N.REAL),
                                     ("w", N.REAL), ("s", N.STRING),
                                     ("b", N.BOOL), ("c", N.INT))}
    i3, f15, t = N.Const(3, N.INT), N.Const(1.5, N.REAL), \
        N.Const(True, N.BOOL)
    p = N.Param("p", N.REAL, default=2.5)
    q = N.Param("q", N.INT, default=4)
    out = []
    for a in (V["k"], V["v"], V["w"], V["s"], V["b"], i3, f15, p, q):
        for b in (V["k"], V["w"], V["s"], V["c"], i3, f15, t, p):
            for op in "+-*/":
                out.append(N.Arith(op, a, b))
            out.append(N.Cmp("<", a, b))
            out.append(N.Cmp("==", a, b))
    out += [N.IfThen(N.Cmp(">", V["k"], i3), V["k"], f15),
            N.IfThen(V["b"], V["w"], V["v"]),
            N.IfThen(V["b"], i3, V["s"]),
            N.BoolOp("&&", V["b"], N.Not(N.Cmp("<=", V["c"], q))),
            N.BoolOp("||", N.Cmp("!=", V["v"], p), t),
            N.NewLabel("L", (("a", V["k"]),)),
            N.NewLabel("L", (("a", V["k"]), ("b", V["s"]), ("c", i3))),
            N.NewLabel("L", (("a", V["v"]), ("b", V["b"])))]
    return out


@pytest.mark.parametrize("params", [None, {"p": -3.0, "q": 2}])
def test_eval_col_expr_matches_reference(params):
    from repro.core import nrc as RN
    from repro.core.plans import eval_col_expr as r_eval
    from repro_torch.core import nrc as TN
    from repro_torch.core.plans import eval_col_expr as t_eval
    ref, port = probe_bag(seed=3)
    checked = 0
    for re_, te in zip(_exprs(RN), _exprs(TN)):
        try:
            want = np.asarray(r_eval(re_, ref, params))
        except TypeError:
            continue        # arithmetic the reference refuses (on bools)
        got = t_eval(te, port, params).numpy()
        checked += 1
        assert got.dtype == want.dtype, (RN.pretty(re_), got.dtype,
                                         want.dtype)
        w = np.broadcast_to(want, got.shape)
        assert np.array_equal(got, w, equal_nan=got.dtype.kind == "f"), \
            RN.pretty(re_)
    assert checked > 250, checked


# ---------------------------------------------------------------------------
# sort sharing (the test_fusion.py pipeline)
# ---------------------------------------------------------------------------

def _pipeline(X, left, right, use_kernel):
    j = X.fk_join(left, right, ("k",), ("k",), use_kernel=use_kernel)
    agg = X.sum_by(j, ("g", "k"), ("v", "rw"), use_kernel=use_kernel)
    return X.nest_level(agg, ("g",), ("k", "v", "rw"), "lbl",
                        use_kernel=use_kernel)


@pytest.mark.parametrize("use_kernel,order_aware", CONFIGS, ids=IDS)
def test_pipeline_sort_stats_match_reference(use_kernel, order_aware):
    left, tleft = probe_bag(seed=0)
    right, tright = build_bag(n=6, seed=0)
    with order_awareness(order_aware):
        rp, rc = _pipeline(RX, left, right, use_kernel)
        tp, tc = _pipeline(TX, tleft, tright, use_kernel)
    assert_bag_parity(rp, tp)
    assert_bag_parity(rc, tc)
    assert_sort_stats_equal()
    # the probe side is sorted exactly once when order-aware
    assert TX.SORT_STATS.get("lexsort", 0) == (1 if order_aware else 2)
