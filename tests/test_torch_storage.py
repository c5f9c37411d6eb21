"""The port's storage engine against the reference's, on the CPU: the
codecs byte for byte, datasets written by either package byte for byte
(chunk files, footers, CRCs, zone maps, sketches) and loading bit for
bit through either reader, ``STORAGE_STATS`` for the same selections,
the fault sites, ``resume`` with sketch quarantine, and morsel plans.
The same nested rows (made from a seed with numpy) go into both."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.columnar import table as RT
from repro.core import nrc as RN
from repro.core.skew import HeavyKeySketch as RSketch
from repro.errors import ReproError as RError
from repro.faults import FAULTS as RFAULTS
from repro.storage import STORAGE_STATS as RSTATS
from repro.storage import StorageCatalog as RCatalog
from repro.storage import encodings as RE
from repro.storage import format as RF
from repro.storage import morsel as RM
from repro.storage import reader as RR
from repro_torch.core import nrc as TN
from repro_torch.core.skew import HeavyKeySketch as TSketch
from repro_torch.errors import ReproError as TError
from repro_torch.faults import FAULTS as TFAULTS
from repro_torch.obs import reset_telemetry
from repro_torch.storage import STORAGE_STATS as TSTATS
from repro_torch.storage import StorageCatalog as TCatalog
from repro_torch.storage import encodings as TE
from repro_torch.storage import format as TF
from repro_torch.storage import morsel as TM
from repro_torch.storage import reader as TR

from test_torch_env import assert_env_parity, assert_np_bag_equal, \
    ref_bag_to_np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

I64_MIN = np.iinfo(np.int64).min
I64_MAX = np.iinfo(np.int64).max


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


def input_types(N) -> dict:
    """``tests/test_storage.py``'s schema, built with either NRC, plus
    an int32 (date) column whose chunks the writer bit-packs."""
    part_t = N.bag(N.tuple_t(pid=N.INT, pname=N.INT, price=N.REAL,
                             mfgr=N.INT))
    ord_t = N.bag(N.tuple_t(
        odate=N.INT,
        oparts=N.bag(N.tuple_t(pid=N.INT, qty=N.REAL, note=N.INT,
                               ship=N.DATE))))
    return {"Ord": ord_t, "Part": part_t}


def gen_data(n_orders=60, n_parts=64, seed=0):
    rng = np.random.RandomState(seed)
    orders = [{"odate": 20200000 + i,
               "oparts": [{"pid": int(rng.randint(1, n_parts + 1)),
                           "qty": float(rng.randint(1, 5)), "note": 7,
                           "ship": int(rng.randint(0, 60000))}
                          for _ in range(rng.randint(0, 6))]}
              for i in range(n_orders)]
    parts = [{"pid": i, "pname": 100 + i, "price": float(i),
              "mfgr": i % 5} for i in range(1, n_parts + 1)]
    return {"Ord": orders, "Part": parts}


DATA = gen_data()


def write_both(tmp_path, name="shop", encoding="auto", chunk_rows=16,
               data=DATA):
    """The same two streamed batches written by each package; returns
    (reference dir, port dir)."""
    dirs = []
    for Cat, N, sub in ((RCatalog, RN, "ref"), (TCatalog, TN, "port")):
        cat = Cat(str(tmp_path / sub))
        w = cat.writer(name, input_types(N), chunk_rows=chunk_rows,
                       encoding=encoding)
        half = len(data["Ord"]) // 2
        w.append({"Ord": data["Ord"][:half], "Part": data["Part"]})
        w.append({"Ord": data["Ord"][half:]})
        dirs.append(w.dir)
    return dirs


def tree_bytes(d) -> dict:
    out = {}
    for dp, _, files in os.walk(d):
        for f in files:
            p = os.path.join(dp, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def stats_without_time(stats) -> dict:
    return {k: v for k, v in dict(stats).items() if k != "decode_us"}


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def _arrays():
    rng = np.random.RandomState(3)
    floats = np.repeat(np.array([-0.0, np.nan, 1.5, 0.0]), [3, 5, 2, 6])
    return {
        "labels": np.repeat(np.arange(40, dtype=np.int64),
                            rng.randint(1, 8, 40)),
        "constant": np.full(300, 7, np.int64),
        "small_span": (1000 + rng.randint(0, 40000, 500)).astype(np.int64),
        "extremes": rng.randint(I64_MIN, I64_MAX, 300, dtype=np.int64),
        "cumsum": np.cumsum(rng.randint(-100, 100, 400)).astype(np.int64),
        "int32": (rng.randint(0, 70000, 300)).astype(np.int32),
        "bool": rng.rand(200) < 0.3,
        "float_runs": floats,
        "float_low_card": rng.randint(1, 50, 400).astype(np.float64),
    }


ARRAYS = _arrays()


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_encode_chunk_and_choice_match_reference(name):
    a = ARRAYS[name]
    codecs = ["rle", "dict"]
    if a.dtype.kind in "iub":
        codecs.append("delta")
        span = int(a.max()) - int(a.min())
        if span.bit_length() <= 16:
            codecs.append("bitpack")
    for codec in codecs:
        want_enc, want_blob = RE.encode_chunk(a, codec)
        got_enc, got_blob = TE.encode_chunk(a, codec)
        assert json.dumps(got_enc) == json.dumps(want_enc), codec
        assert got_blob.tobytes() == want_blob.tobytes(), codec
    zs = TF.zone_stats(a)
    assert json.dumps(zs) == json.dumps(RF.zone_stats(a))
    assert TE.choose_encoding(a, zs) == RE.choose_encoding(a, zs)
    assert TF.chunk_crc(a) == RF.chunk_crc(a)


@pytest.mark.parametrize("seed", range(6))
def test_heavy_key_sketch_matches_reference(seed):
    """The port's array-based update keeps the reference's counters, in
    the reference's dict order, over batches that stay under ``k``
    distinct keys and batches of thousands of distinct keys."""
    rng = np.random.RandomState(seed)
    k = [1, 2, 8, 64, 64, 8][seed]
    ref, port = RSketch(k=k), TSketch(k=k)
    for _ in range(5):
        n = int(rng.choice([0, 1, 3, 10, 60, 500, 5000]))
        batch = [rng.zipf(1.3, n) % 1000, rng.randint(-5, 5, n),
                 rng.randint(-2 ** 62, 2 ** 62, n),
                 np.repeat(np.arange(n // 3 + 1), 3)[:n]][rng.randint(0, 4)]
        ref.update(batch)
        port.update(batch)
        assert list(port.counts.items()) == list(ref.counts.items())
        assert port.error_bound() == ref.error_bound()
    assert port.to_json() == ref.to_json()
    assert port.heavy(0.05) == ref.heavy(0.05)
    back = TSketch.from_json(port.to_json())
    assert back.to_json() == ref.to_json()


# ---------------------------------------------------------------------------
# datasets: written byte for byte, loaded bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("encoding", ["auto", "raw"])
def test_streamed_datasets_byte_identical(tmp_path, encoding):
    ref_dir, port_dir = write_both(tmp_path, encoding=encoding)
    want, got = tree_bytes(ref_dir), tree_bytes(port_dir)
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f
    doc = json.loads(want["footer.json"])
    codecs = {enc["codec"] for p in doc["parts"].values()
              for c in p["chunks"] for enc in c.get("encodings", {}).values()}
    assert codecs == (set() if encoding == "raw"
                      else {"rle", "delta", "bitpack", "dict"}), codecs


def test_write_parts_byte_identical(tmp_path):
    """The chip run's path: shredded TPC-H parts persisted directly."""
    env_np = chip_smoke.shred_ncop2(chip_smoke.gen_tpch_columns(400, 3))
    dirs = []
    for Cat, N, sub in ((RCatalog, RN, "ref"), (TCatalog, TN, "port")):
        part_t, ncop2_t = chip_smoke.tpch_types() if N is TN else (
            RN.bag(RN.tuple_t(pid=RN.INT, pname=RN.INT, price=RN.REAL)),
            RN.bag(RN.tuple_t(cname=RN.INT, corders=RN.bag(RN.tuple_t(
                odate=RN.INT, oparts=RN.bag(RN.tuple_t(pid=RN.INT,
                                                       qty=RN.REAL)))))))
        w = Cat(str(tmp_path / sub)).writer(
            "tpch", {"NCOP2": ncop2_t, "Part": part_t}, chunk_rows=256)
        if N is TN:
            from repro_torch.columnar.table import env_from_numpy
            env = env_from_numpy(env_np, "cpu")
        else:
            env = {k: RT.FlatBag({c: jnp.asarray(a) for c, a in cols.items()},
                                 jnp.asarray(valid))
                   for k, (cols, valid) in env_np.items()}
        w.write_parts(env)
        dirs.append(w.dir)
    want, got = tree_bytes(dirs[0]), tree_bytes(dirs[1])
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("encoding", ["auto", "raw"])
def test_either_package_reads_either_dataset(tmp_path, writer, encoding):
    ref_dir, port_dir = write_both(tmp_path, encoding=encoding)
    d = ref_dir if writer == "ref" else port_dir
    rds = RR.StoredDataset(d)
    tds = TR.StoredDataset(d, device="cpu")
    assert json.dumps(tds.meta.to_json()) == json.dumps(rds.meta.to_json())
    assert tds.fingerprint() == rds.fingerprint()
    for name in rds.parts:
        assert tds.parts[name].stats().to_json() \
            == rds.parts[name].stats().to_json()
    assert_env_parity(rds.load_env(), tds.load_env())
    assert_env_parity(rds.load_env(verify=True),
                      tds.load_env(verify=True))


def test_device_decode_path_matches_numpy_on_every_chunk(tmp_path):
    """``reader._decode_device`` (run here with the kernels' plain
    versions) decodes every encoded chunk of a dataset as
    ``encodings.decode_chunk`` does, bit for bit."""
    _, port_dir = write_both(tmp_path)
    ds = TR.StoredDataset(port_dir, device="cpu")
    seen = set()
    for part in ds.parts.values():
        for i, ch in enumerate(part.meta.chunks):
            for col, enc in ch.encodings.items():
                blob = np.load(TF.chunk_path(port_dir, part.name, col, i))
                got = TR._decode_device(enc, blob, "cpu").numpy()
                want = TE.decode_chunk(enc, blob)
                assert got.dtype == want.dtype
                assert got.tobytes() == want.tobytes(), (part.name, col, i)
                seen.add(enc["codec"])
    assert seen == {"rle", "delta", "bitpack", "dict"}


def _pred(N, price: float):
    return N.Cmp(">=", N.Var("price", N.REAL), N.Const(price, N.REAL))


@pytest.mark.parametrize("case", ["all", "columns", "pred", "chunks"])
def test_storage_stats_match_reference(tmp_path, case):
    ref_dir, port_dir = write_both(tmp_path)
    rds = RR.StoredDataset(ref_dir)
    tds = TR.StoredDataset(port_dir, device="cpu")
    RR.reset_storage_stats()
    TR.reset_storage_stats()
    for name in sorted(rds.parts):
        rp, tp = rds.parts[name], tds.parts[name]
        cols, chunks = None, None
        if case == "columns":
            cols = rp.columns[:2]
        elif case == "pred" and name == "Part__F":
            chunks = rp.select_chunks(_pred(RN, 40.0))
            assert tp.select_chunks(_pred(TN, 40.0)) == chunks
            assert 0 < len(chunks) < rp.n_chunks
        elif case == "chunks":
            chunks = list(range(0, rp.n_chunks, 2))
        rb = rp.load(columns=cols, chunks=chunks, capacity=rp.rows + 5)
        tb = tp.load(columns=cols, chunks=chunks, capacity=rp.rows + 5)
        assert_np_bag_equal(ref_bag_to_np(rb),
                            ({c: a.numpy() for c, a in tb.data.items()},
                             tb.valid.numpy()), name)
        assert tb.props.sorted_by == rb.props.sorted_by
        assert tb.props.invalid_last == rb.props.invalid_last
    assert stats_without_time(TSTATS) == stats_without_time(RSTATS)
    assert TSTATS["chunks_read"] > 0


# ---------------------------------------------------------------------------
# faults, resume, sketch quarantine
# ---------------------------------------------------------------------------

def _load_error(faults, part, kind, verify) -> str:
    try:
        faults.reset(0)
        faults.arm("storage.chunk", kind, first=0, count=1,
                   arg=0.5 if kind == "torn" else None)
        part.load(verify=verify)
        return "none"
    except (RError, TError) as e:
        return type(e).__name__
    finally:
        faults.reset()


@pytest.mark.parametrize("kind,verify", [("missing", False),
                                         ("torn", False),
                                         ("corrupt", False),
                                         ("corrupt", True)])
@pytest.mark.parametrize("part", ["Part__F", "Ord__D_oparts"])
def test_chunk_faults_raise_the_same_types(tmp_path, part, kind, verify):
    ref_dir, port_dir = write_both(tmp_path)
    want = _load_error(RFAULTS, RR.StoredDataset(ref_dir).parts[part],
                       kind, verify)
    got = _load_error(TFAULTS, TR.StoredDataset(
        port_dir, device="cpu").parts[part], kind, verify)
    assert got == want
    assert want != "none" or (kind == "corrupt" and not verify)


def test_footer_faults_raise_the_same_types(tmp_path):
    from repro.errors import FooterError as RFooter
    from repro_torch.errors import FooterError as TFooter
    ref_dir, port_dir = write_both(tmp_path)
    for faults, open_, err in ((RFAULTS, lambda: RR.StoredDataset(ref_dir),
                                RFooter),
                               (TFAULTS, lambda: TR.StoredDataset(
                                   port_dir, device="cpu"), TFooter)):
        try:
            faults.reset(0)
            faults.arm("storage.footer", "corrupt", first=0, count=1)
            with pytest.raises(err):
                open_()
        finally:
            faults.reset()


def test_resume_and_sketch_quarantine_match_reference(tmp_path):
    """A torn append left a sketch counting rows the footer lacks:
    both writers quarantine the same sketches on resume and then write
    the same bytes."""
    dirs, quarantined = [], []
    for Cat, N, sub in ((RCatalog, RN, "ref"), (TCatalog, TN, "port")):
        cat = Cat(str(tmp_path / sub))
        w = cat.writer("stale", input_types(N), chunk_rows=16)
        w.append({"Ord": DATA["Ord"][:20], "Part": DATA["Part"]})
        fpath = os.path.join(w.dir, "footer.json")
        with open(fpath) as f:
            doc = json.load(f)
        sk = doc["parts"]["Ord__D_oparts"]["sketches"]["pid"]
        sk["total"] = int(sk["total"]) + 50
        with open(fpath, "w") as f:
            json.dump(doc, f)
        w2 = cat.writer("stale", input_types(N), chunk_rows=16, resume=True)
        quarantined.append(w2.quarantined_sketches)
        w2.append({"Ord": DATA["Ord"][20:]})
        dirs.append(w2.dir)
    assert quarantined[1] == quarantined[0]
    assert "pid" in quarantined[0]["Ord__D_oparts"]
    assert tree_bytes(dirs[1]) == tree_bytes(dirs[0])


# ---------------------------------------------------------------------------
# morsel plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("morsel_rows", [4, 9, 1000])
def test_plan_morsels_and_windows_match_reference(tmp_path, morsel_rows):
    ref_dir, port_dir = write_both(tmp_path, chunk_rows=4)
    rds = RR.StoredDataset(ref_dir)
    tds = TR.StoredDataset(port_dir, device="cpu")
    rp = RM.plan_morsels(rds, "Ord", morsel_rows)
    tp = TM.plan_morsels(tds, "Ord", morsel_rows)
    assert (tp.root, tp.parts, tp.caps) == (rp.root, rp.parts, rp.caps)
    assert [{k: (w.chunks, w.lo, w.hi) for k, w in m.items()}
            for m in tp.morsels] == \
        [{k: (w.chunks, w.lo, w.hi) for k, w in m.items()}
         for m in rp.morsels]
    for rm, tm in zip(rp.morsels, tp.morsels):
        for part in rp.parts:
            rb = RM.load_morsel_window(rds.parts[part], rm[part], None,
                                       rp.caps[part])
            tb = TM.load_morsel_window(tds.parts[part], tm[part], None,
                                       tp.caps[part])
            assert_np_bag_equal(ref_bag_to_np(rb),
                                ({c: a.numpy() for c, a in tb.data.items()},
                                 tb.valid.numpy()), part)


def test_device_rule_of_the_reader(tmp_path, monkeypatch):
    """``StoredDataset`` takes the GPU unless asked for the CPU, and
    refuses to run without one."""
    _, port_dir = write_both(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        TR.StoredDataset(port_dir)
    ds = TR.StoredDataset(port_dir, device="cpu")
    assert all(p.device.type == "cpu" for p in ds.parts.values())
    assert ds.load_env()["Part__F"].device.type == "cpu"
    # a part opened on its own follows the same rule
    meta = ds.meta.parts["Part__F"]
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        TR.StoredPart(port_dir, meta)
    part = TR.StoredPart(port_dir, meta, device="cpu")
    assert part.device == torch.device("cpu")
    assert part.load().device.type == "cpu"
