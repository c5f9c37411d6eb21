"""The port's FlatBag and environments against the reference's, plus the
comparison helpers every ``test_torch_*`` parity test uses.

Parity, as the props contract defines it (``columnar/props.py``):
equal capacities and dtypes, ``valid`` equal element by element, data
equal at every valid row (values at invalid rows are unspecified).
Ints, labels and bools compare bit for bit; floats compare by their bit
pattern too (the tests use integer-valued floats, exact in any order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.columnar import table as RT
from repro.core import codegen as RCG
from repro_torch.columnar import table as TT
from repro_torch.core import codegen as TCG
from repro_torch.obs import reset_telemetry

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


# ---------------------------------------------------------------------------
# helpers (imported by the other test_torch_* files)
# ---------------------------------------------------------------------------

def ref_bag_to_np(bag):
    return ({c: np.asarray(a) for c, a in bag.data.items()},
            np.asarray(bag.valid))


def ref_env_to_np(env) -> dict:
    """Reference FlatBag env -> ``{name: (columns, valid)}``."""
    return {name: ref_bag_to_np(bag) for name, bag in env.items()}


def port_env(env_ref) -> dict:
    """The reference's env, carried into the port on the CPU."""
    return TT.env_from_numpy(ref_env_to_np(env_ref), CPU)


def _bits(a: np.ndarray) -> np.ndarray:
    if a.dtype == np.float64:
        return a.view(np.int64)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def assert_np_bag_equal(want, got, what="") -> None:
    """``want``/``got`` as (columns, valid) numpy pairs."""
    wcols, wvalid = want
    gcols, gvalid = got
    assert wvalid.shape == gvalid.shape, (what, wvalid.shape, gvalid.shape)
    assert np.array_equal(wvalid, gvalid), (what, "valid", wvalid, gvalid)
    assert set(wcols) == set(gcols), (what, sorted(wcols), sorted(gcols))
    for c in wcols:
        w, g = wcols[c], gcols[c]
        assert w.dtype == g.dtype, (what, c, w.dtype, g.dtype)
        assert w.shape == g.shape, (what, c, w.shape, g.shape)
        assert np.array_equal(_bits(w)[wvalid], _bits(g)[wvalid]), \
            (what, c, w[wvalid], g[wvalid])


def assert_bag_parity(ref_bag, port_bag, what="") -> None:
    assert_np_bag_equal(ref_bag_to_np(ref_bag),
                        TT.env_to_numpy({"b": port_bag})["b"], what)


def assert_env_parity(ref_env, port_env_, names=None) -> None:
    names = list(ref_env) if names is None else list(names)
    for n in names:
        assert_bag_parity(ref_env[n], port_env_[n], n)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

ROWS = [{"k": 3, "s": "b", "x": 1.5, "b": True, "d": 7, "l": 11},
        {"k": -1, "s": "a", "x": -0.0, "b": False, "d": 8, "l": 12},
        {"k": 3, "s": "b", "x": 2.0, "b": True, "d": 9, "l": 13}]
SCHEMA = {"k": "int", "s": "string", "x": "real", "b": "bool", "d": "date",
          "l": "label"}


def _both(capacity=None):
    ref = RT.FlatBag.from_rows(ROWS, SCHEMA, capacity=capacity)
    port = TT.FlatBag.from_rows(ROWS, SCHEMA, capacity=capacity,
                                device="cpu")
    return ref, port


@pytest.mark.parametrize("capacity", [None, 3, 8])
def test_from_rows_matches_reference(capacity):
    ref, port = _both(capacity)
    assert port.capacity == ref.capacity
    assert_bag_parity(ref, port)
    assert port.to_rows() == ref.to_rows()
    assert int(port.count()) == int(ref.count())
    assert port.count().dtype == torch.int32
    assert port.row_bytes() == ref.row_bytes()


@pytest.mark.parametrize("capacity", [2, 5, 12])
def test_resize_compact_concat_match_reference(capacity):
    ref, port = _both(6)
    ref = ref.mask(jnp.asarray([True, False, True, False, False, False]))
    port = port.mask(torch.tensor([True, False, True, False, False, False]))
    assert_bag_parity(ref.resize(capacity), port.resize(capacity))
    assert_bag_parity(ref.compact(), port.compact())
    assert_bag_parity(RT.concat_bags(ref, ref), TT.concat_bags(port, port))
    rb, rd = RT.concat_compact(ref, ref, capacity)
    tb, td = TT.concat_compact(port, port, capacity)
    assert_bag_parity(rb, tb)
    assert int(rd) == int(td) and td.dtype == torch.int64


def test_env_round_trip_and_device_rule(monkeypatch):
    ref, _ = _both(4)
    env_np = ref_env_to_np({"R__F": ref})
    env = TT.env_from_numpy(env_np, "cpu")
    assert env["R__F"].device == CPU
    assert_np_bag_equal(env_np["R__F"], TT.env_to_numpy(env)["R__F"])
    # None means the GPU; with no GPU the entry points refuse and name
    # the way out, rather than carrying on quietly on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TT.env_from_numpy(env_np),
                 lambda: TT.FlatBag.from_rows(ROWS, SCHEMA),
                 lambda: TCG.columnar_shred_inputs({}, {})):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_columnar_shred_inputs_matches_reference():
    from test_torch_queries import QS_COP, QS_PARTS, quickstart
    from repro.core import nrc as RN
    from repro_torch.core import nrc as TN
    _, rtypes = quickstart(RN)
    _, ttypes = quickstart(TN)
    inputs = {"COP": QS_COP, "Part": QS_PARTS}
    ref = RCG.columnar_shred_inputs(inputs, rtypes)
    port = TCG.columnar_shred_inputs(inputs, ttypes, device="cpu")
    assert list(port) == list(ref)
    for n in ref:
        assert list(port[n].data) == list(ref[n].data), n
    assert_env_parity(ref, port)
    caps = {"COP__D_corders": 7}
    assert_env_parity(
        RCG.columnar_shred_inputs(inputs, rtypes, capacities=caps),
        TCG.columnar_shred_inputs(inputs, ttypes, capacities=caps,
                                  device="cpu"))
