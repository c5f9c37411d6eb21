"""Distributed execution over a virtual mesh (PyTorch twin of
``repro.exec.dist``).

The reference runs the per-partition code under ``shard_map`` on P
devices. Here the P partitions are the *sites* of a virtual mesh on one
torch device (``device_mesh_1d``): each site runs the same
per-partition code on its own row shard, on a thread of its own, and
the collectives meet at one rendezvous where they are real copies and
reductions in device memory, in site order:

* ``all_to_all`` — site ``d`` receives ``cat([send_s[d] for s in
  sites])``, one device copy per site: the wire;
* ``all_gather`` (tiled) — the sites' values concatenated in site order;
* ``psum`` / ``pmax`` — the stacked values reduced in site order (they
  are integers, so the result is exact).

What the reference records once, when it traces the per-partition code
(``SHUFFLE_STATS``, the other host counters, the size gauges, spans and
fault sites), site 0 records on a compile attempt, and no site on a warm
call (``obs.metrics.host_recording``). The per-site device metrics
(``DistContext._add`` / ``_add_max``) stay per site; ``psum`` and
``pmax`` combine them in ``finalize_metrics``. A site that raises aborts
the rendezvous: the others stop at their next collective and the run
raises the failing site's own exception. Every wait has a timeout, and
a rendezvous refuses sites that arrive at different collectives.

The exchange itself follows the reference line for line. The default
(**packed**) exchange routes rows by a destination sort (cached per key
set in ``PhysicalProps.route_cache``) and ships every column in ONE
collective as a ``(P, bucket, n_lanes)`` int64 buffer, packed by the
``pack_rows`` kernel and unpacked by ``unpack_cols`` when ``use_kernel``
is set; exchanges whose key is a superset of a delivered partitioning
are elided; bucket capacities are adaptive (``compile_distributed(
adaptive=True)``). ``shuffle_mode="legacy"`` selects the seed path (one
collective per column, no elision), the benchmarks' baseline. Broadcast
joins ``all_gather`` the small side; the skew-aware join (paper Fig. 6)
exchanges only the light component and gathers the heavy build rows;
``multi_join`` is the HyperCube one-round multiway join with all
relations in one collective, packed by ``replicate_scatter``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.columnar.table import (FlatBag, concat_bags, concat_compact,
                                        resolve_device)
from repro_torch.core import skew as SK
from repro_torch.errors import ExchangeError, ExecError
from repro_torch.faults import FAULTS
from repro_torch.obs.metrics import REGISTRY as _METRICS
from repro_torch.obs.metrics import host_recording_as
from repro_torch.obs.trace import span as _span
from . import ops as X
from .hashing import mix64


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


# ---------------------------------------------------------------------------
# shuffle accounting (host counters, the SORT_STATS analogue)
# ---------------------------------------------------------------------------

SHUFFLE_STATS = _METRICS.view("shuffle")
"""Shuffle accounting — live view onto the metrics registry under the
``shuffle.`` domain. Per-site keys (``size_used_<n>``,
``replication_x100_<n>``) are gauges wiped by every registry reset;
``compile_distributed`` resets the domain per attempt."""


def reset_shuffle_stats() -> None:
    SHUFFLE_STATS.clear()


def _scount(name: str, n: int = 1) -> None:
    _METRICS.inc("shuffle." + name, n)


def _roundup8(n: int) -> int:
    return max(-(-int(n) // 8) * 8, 1)


# ---------------------------------------------------------------------------
# the virtual mesh and its rendezvous
# ---------------------------------------------------------------------------

class MeshAborted(ExecError):
    """Raised at a collective of a site whose run another site aborted;
    the run raises the aborting site's own exception instead."""


class CollectiveMismatchError(ExecError):
    """Sites arrived at different collectives (or one finished while
    others waited): the per-site programs diverged."""


class CollectiveTimeout(ExecError):
    """A collective waited longer than ``_WAIT_S``."""


_WAIT_S = 600.0
"""How long, in seconds, a site waits at a collective for the others;
a run's sites are joined within four times as long."""


class VirtualMesh:
    """``n`` sites of one mesh axis on one torch device (the twin of a
    1-D ``jax.sharding.Mesh``). ``shape[axis]`` is ``n``."""

    def __init__(self, n: int, axis: str = "data", device=None):
        if n < 1:
            raise ValueError(f"a mesh needs at least one site; got {n}")
        self.n = int(n)
        self.axis = axis
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.shape = {axis: self.n}

    @property
    def size(self) -> int:
        return self.n

    @property
    def axis_names(self) -> Tuple[str]:
        """The mesh's axis names, as a ``jax.sharding.Mesh`` has them."""
        return (self.axis,)

    def __repr__(self) -> str:
        return (f"VirtualMesh({self.n} sites, axis={self.axis!r}, "
                f"device={self.device})")


def device_mesh_1d(n: int, axis: str = "data",
                   device=None) -> VirtualMesh:
    """A mesh of ``n`` sites on one device: the GPU when ``device`` is
    None (raising where there is none), else the device given."""
    return VirtualMesh(n, axis, device)


class _Rendezvous:
    """Where the sites of one run meet. ``gather(site, tag, value)``
    blocks until every site has called it with the same ``tag``, then
    returns every site's value in site order. Each collective collects
    into a list of its own, which its waiters keep: a site may already
    arrive at the next collective while others still read this one, and
    the values are freed when the last site has read them."""

    def __init__(self, n: int):
        self.n = n
        self._cond = threading.Condition()
        self._gen = 0
        self._arrived = 0
        self._tag = None
        self._slots: list = []
        self._done: set = set()
        self._error: Optional[BaseException] = None

    def _fail(self, err: BaseException) -> None:
        if self._error is None:
            self._error = err
        self._cond.notify_all()

    def abort(self, err: BaseException) -> None:
        with self._cond:
            self._fail(err)

    def finish(self, site: int) -> None:
        """Site ``site`` ran to its end: any collective still waiting
        can never complete."""
        with self._cond:
            self._done.add(site)
            if self._arrived and self._error is None:
                self._fail(CollectiveMismatchError(
                    f"site {site} finished while other sites wait at "
                    f"collective {self._tag}"))
                raise self._error

    def gather(self, site: int, tag, value) -> list:
        with self._cond:
            if self._error is not None:
                raise MeshAborted(f"site {site}: run aborted at {tag}")
            if self._done:
                self._fail(CollectiveMismatchError(
                    f"site {site} reached collective {tag} after sites "
                    f"{sorted(self._done)} finished"))
                raise self._error
            if self._arrived == 0:
                self._tag = tag
                self._slots = [None] * self.n
            elif tag != self._tag:
                self._fail(CollectiveMismatchError(
                    f"site {site} reached collective {tag} while other "
                    f"sites wait at {self._tag}"))
                raise self._error
            gen = self._gen
            slots = self._slots
            slots[site] = value
            self._arrived += 1
            if self._arrived == self.n:
                self._arrived = 0
                self._gen += 1
                self._cond.notify_all()
            else:
                ok = self._cond.wait_for(
                    lambda: self._gen != gen or self._error is not None,
                    timeout=_WAIT_S)
                if self._error is not None:
                    raise MeshAborted(f"site {site}: run aborted at {tag}")
                if not ok:
                    self._fail(CollectiveTimeout(
                        f"collective {tag} waited {_WAIT_S} s for "
                        f"the other sites"))
                    raise self._error
            return slots


# ---------------------------------------------------------------------------
# per-site operators
# ---------------------------------------------------------------------------

class DistContext:
    """Collective operators + metering for one site of a virtual-mesh
    run (the reference's context of one shard_map region). ``site`` is
    this site's index on the axis; ``device`` where its metrics live (the
    GPU when None, as ``resolve_device`` gives it). A one-site context
    makes its own rendezvous."""

    def __init__(self, axis: str, n_partitions: int,
                 cap_factor: float = 2.0, sample: int = 256,
                 threshold: float = 0.025, skew_default: bool = False,
                 packed: bool = True,
                 size_plan: Optional[Sequence[int]] = None,
                 use_kernel: bool = False, site: int = 0,
                 device=None, rendezvous: Optional[_Rendezvous] = None):
        self.axis = axis
        self.P = n_partitions
        self.cap_factor = cap_factor
        self.sample = sample
        self.threshold = threshold
        self.skew_default = skew_default
        self.packed = packed
        self.size_plan = size_plan
        self.use_kernel = use_kernel
        self.site = site
        self.device = resolve_device(device)
        if rendezvous is None:
            assert n_partitions == 1, "a multi-site context needs its mesh"
            rendezvous = _Rendezvous(1)
        self._rv = rendezvous
        self.metrics: Dict[str, torch.Tensor] = {}
        self.max_metrics: Dict[str, torch.Tensor] = {}
        self._n_sites = 0

    # -- collectives ----------------------------------------------------
    def _gather(self, name: str, value) -> list:
        return self._rv.gather(self.site, (name, self._n_sites), value)

    def _psum(self, v: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._gather("psum", v)).sum(0)

    def _all_gather(self, v: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._gather("all_gather", v))

    def _all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send`` (P, ...): block ``d`` goes to site ``d``; returns the
        blocks this site receives, stacked in sender order."""
        sends = self._gather("all_to_all", send)
        return torch.stack([s[self.site] for s in sends])

    # -- metering -----------------------------------------------------
    def _i64(self, value) -> torch.Tensor:
        return torch.as_tensor(value, dtype=torch.int64, device=self.device)

    def _add(self, name: str, value):
        v = self._i64(value)
        cur = self.metrics.get(name)
        self.metrics[name] = v if cur is None else cur + v

    def _add_max(self, name: str, value):
        v = self._i64(value)
        cur = self.max_metrics.get(name)
        self.max_metrics[name] = v if cur is None else torch.maximum(cur, v)

    def finalize_metrics(self) -> Dict[str, torch.Tensor]:
        """psum of the summed metrics and pmax of the max metrics over
        the sites, in one collective."""
        keys, mkeys = sorted(self.metrics), sorted(self.max_metrics)
        vec = torch.stack([self.metrics[k] for k in keys]
                          + [self.max_metrics[k] for k in mkeys]) \
            if keys or mkeys else self._i64([])
        got = self._gather("finalize_metrics", (keys, mkeys, vec))
        if any(g[0] != keys or g[1] != mkeys for g in got):
            raise CollectiveMismatchError(
                "sites finished with different metric names: "
                f"{[(g[0], g[1]) for g in got]}")
        stacked = torch.stack([g[2] for g in got])
        n = len(keys)
        out = dict(zip(keys, stacked[:, :n].sum(0)))
        out.update(zip(mkeys, stacked[:, n:].amax(0)) if mkeys else ())
        return out

    # -- adaptive sizing sites ----------------------------------------
    def _size_site(self, default: int) -> Tuple[int, int]:
        """Claim the next capacity-sizing site (exchange bucket or union
        capacity). Sites are numbered in program order, which is
        deterministic, so a retry with a ``size_plan`` addresses exactly
        the site that recorded the need."""
        site = self._n_sites
        self._n_sites += 1
        used = int(default)
        if self.size_plan is not None and site < len(self.size_plan):
            used = int(self.size_plan[site])
        _METRICS.set_gauge(f"shuffle.size_used_{site}", used)
        return site, used

    # -- routing ----------------------------------------------------------
    def _route(self, destk: torch.Tensor) -> tuple:
        """Destination-sort routing: (order, counts, offsets) over
        ``destk`` (P for rows that do not travel, which sort last; the
        sort is stable, so sender order is kept). The counts come from
        the sorted destinations' boundaries: a scatter-add into P + 1
        counters contends on a few addresses on the card."""
        Pn = self.P
        dsorted, order = torch.sort(destk, stable=True)
        bounds = torch.searchsorted(
            dsorted, torch.arange(Pn + 1, dtype=dsorted.dtype,
                                  device=dsorted.device))
        counts = bounds[1:] - bounds[:-1]
        offsets = torch.cumsum(counts, 0) - counts
        return order, counts, offsets

    def _pack(self, lanes: List[torch.Tensor], route: tuple, bucket: int,
              n_src: int, use_kernel: bool,
              repl: Optional[int] = None) -> torch.Tensor:
        """The (P * bucket, n_lanes) send buffer: each slot holds the
        routed row it takes, or zeros. ``repl`` (the HyperCube
        exchange): the routed ids are virtual rows, row ``id // repl``.
        Its temporaries die with the call, before the collective."""
        mat = torch.stack(lanes, dim=1)                   # (rows, n_lanes)
        take, slot_ok = self._slots(route, bucket, n_src)
        if use_kernel:
            from repro_torch.kernels import ops as kops
            if repl is None:
                return kops.pack_rows(mat, take, slot_ok)
            return kops.replicate_scatter(mat, take, slot_ok, repl)
        send = mat[take if repl is None else take // repl]
        return send.masked_fill_(~slot_ok[:, None], 0)

    def _slots(self, route: tuple, bucket: int, n_src: int):
        """For every slot of the (P * bucket) send buffer: the routed
        row it takes (``take``) and whether it holds one (``slot_ok``)."""
        order, counts, offsets = route
        dev = order.device
        slot = torch.arange(self.P * bucket, device=dev)
        pdest = slot // bucket
        within = slot % bucket
        slot_ok = within < counts[pdest]
        take = order[(offsets[pdest] + within).clamp(0, n_src - 1)]
        return take, slot_ok

    # -- exchange (hash repartition) ------------------------------------
    def exchange(self, bag: FlatBag, key_cols: Sequence[str],
                 keep: Optional[torch.Tensor] = None,
                 key: Optional[torch.Tensor] = None) -> FlatBag:
        """Hash-repartition by key (span-traced wrapper; see
        ``_exchange``)."""
        with _span("exchange", keys=tuple(key_cols), site=self._n_sites):
            return self._exchange(bag, key_cols, keep, key)

    def _exchange(self, bag: FlatBag, key_cols: Sequence[str],
                  keep: Optional[torch.Tensor] = None,
                  key: Optional[torch.Tensor] = None) -> FlatBag:
        """Hash-repartition rows by key over the mesh. ``keep``
        optionally restricts which rows participate (others are dropped
        — the skew-aware ops exchange only light rows); ``key``
        optionally supplies the pre-packed key.

        Elision: when the bag is already hash-partitioned on a subset of
        ``key_cols`` (``PhysicalProps.partitioning``), equal keys are
        already co-located and the exchange is a no-op.

        Wire format (packed mode): every column as an int64 lane,
        stacked with a packed-key lane (pre-seeding the receiving key
        cache) and a validity lane into one ``(P, bucket, n_lanes)``
        buffer — one ``all_to_all`` total. Within each (sender, dest)
        block rows arrive contiguously in sender order; slots past the
        sender's count arrive zero with validity 0."""
        rule = FAULTS.hit("dist.exchange", keys=tuple(key_cols))
        if rule is not None and rule.kind == "fail":
            raise ExchangeError(
                f"injected exchange failure (keys={tuple(key_cols)})")
        key_cols = tuple(key_cols)
        if not self.packed:
            return self._exchange_legacy(bag, key_cols, keep, key)
        if X.ORDER_AWARE and bag.props.partitioned_for(key_cols):
            _scount("exchange_elided")
            return bag if keep is None else bag.mask(keep)
        _scount("exchanges")
        cap = bag.capacity
        Pn = self.P
        valid = bag.valid if keep is None else (bag.valid & keep)
        if key is None:
            key = X.pack_keys(bag, key_cols)

        # -- destination-sort routing (cached when validity untouched) --
        route = None
        if X.ORDER_AWARE and keep is None:
            route = bag.props.route_cache.get(key_cols)
            if route is not None:
                _scount("route_reuse")
        if route is None:
            _scount("route_argsort")
            dest = mix64(key) % Pn
            route = self._route(torch.where(valid, dest, Pn))
            if X.ORDER_AWARE and keep is None:
                bag.props.route_cache[key_cols] = route
        counts = route[1]

        # -- adaptive bucket sizing -------------------------------------
        site, bucket = self._size_site(
            max(int(cap * self.cap_factor) // Pn, 1))
        self._add_max(f"size_need_{site}", counts.max())

        # -- partition balance metering ---------------------------------
        # total rows each partition will RECEIVE at this site (psum of
        # the per-sender destination counts)
        recv = self._psum(counts)
        self._add_max(f"part_max_{site}", recv.max())
        self._add(f"part_rows_{site}", counts.sum())

        sent = torch.minimum(counts, self._i64(bucket)).sum()
        self._add("overflow_rows", (counts - bucket).clamp(min=0).sum())
        self._add("shuffle_rows", sent)
        # order-aware exchanges ship the packed key as one extra lane
        key_lane = 8 if X.ORDER_AWARE else 0
        self._add("shuffle_bytes", sent * (bag.row_bytes() + key_lane))

        # -- pack: one int64 lane per column + key + validity -----------
        names = bag.columns
        lanes = [X._to_i64_bits(bag.data[n]) for n in names]
        if X.ORDER_AWARE:
            lanes.append(key)
        lanes.append(valid.to(torch.int64))
        n_lanes = len(lanes)
        send = self._pack(lanes, route, bucket, cap, self.use_kernel)
        del lanes

        # -- the single collective --------------------------------------
        _scount("collectives")
        recv = self._all_to_all(
            send.reshape(Pn, bucket, n_lanes)).reshape(Pn * bucket, n_lanes)
        del send

        # -- unpack: lane i of the wire buffer is column i ---------------
        if self.use_kernel:
            from repro_torch.kernels import ops as kops
            cols = kops.unpack_cols(recv)
        else:
            cols = recv.t()
        del recv

        def lane(i):
            return cols[i]

        out_data = {n: X._from_i64_bits(lane(i), bag.data[n].dtype)
                    for i, n in enumerate(names)}
        vrecv = lane(n_lanes - 1) != 0
        props = None
        if X.ORDER_AWARE:
            from repro_torch.columnar.props import PhysicalProps
            props = PhysicalProps(key_cache={key_cols: lane(len(names))},
                                  partitioning=key_cols)
        return FlatBag(out_data, vrecv, props)

    def _exchange_legacy(self, bag: FlatBag, key_cols: Tuple[str, ...],
                         keep: Optional[torch.Tensor],
                         key: Optional[torch.Tensor]) -> FlatBag:
        """Seed-era exchange: dense one-hot/cumsum scatter and one
        ``all_to_all`` per column — kept as the benchmarks' baseline
        (``shuffle_mode="legacy"``)."""
        _scount("exchanges")
        cap = bag.capacity
        Pn = self.P
        dev = bag.device
        bucket = max(int(cap * self.cap_factor) // Pn, 1)
        if key is None:
            key = X.pack_keys(bag, key_cols)
        valid = bag.valid if keep is None else (bag.valid & keep)
        dest = torch.where(valid, mix64(key) % Pn, 0)
        onehot = (dest[:, None] == torch.arange(Pn, device=dev)[None, :]) \
            & valid[:, None]
        pos = torch.cumsum(onehot.to(torch.int64), 0) - 1
        pos = torch.take_along_dim(pos, dest[:, None], 1)[:, 0]
        ok = valid & (pos < bucket)
        self._add("overflow_rows", (valid & (pos >= bucket)).sum())
        self._add("shuffle_rows", ok.sum())
        key_lane = 8 if X.ORDER_AWARE else 0
        self._add("shuffle_bytes", ok.sum() * (bag.row_bytes() + key_lane))

        # rows that do not travel scatter to one spare slot past the end
        flat = torch.where(ok, dest * bucket + pos, Pn * bucket)

        def scatter(col):
            buf = torch.zeros(Pn * bucket + 1, dtype=col.dtype, device=dev)
            buf.scatter_(0, flat, torch.where(ok, col, torch.zeros_like(col)))
            return buf[:-1].reshape(Pn, bucket)

        def a2a(buf):
            _scount("collectives")
            return self._all_to_all(buf).reshape(Pn * bucket)

        out_data = {n: a2a(scatter(a)) for n, a in bag.data.items()}
        vrecv = a2a(scatter(ok))
        props = None
        if X.ORDER_AWARE:
            from repro_torch.columnar.props import PhysicalProps
            props = PhysicalProps(key_cache={key_cols: a2a(scatter(key))})
        return FlatBag(out_data, vrecv, props)

    # -- broadcast (all_gather) -----------------------------------------
    def gather_all(self, bag: FlatBag,
                   keep: Optional[torch.Tensor] = None) -> FlatBag:
        with _span("broadcast", cols=bag.columns):
            return self._gather_all(bag, keep)

    def _gather_all(self, bag: FlatBag,
                    keep: Optional[torch.Tensor] = None) -> FlatBag:
        valid = bag.valid if keep is None else (bag.valid & keep)
        self._add("broadcast_bytes",
                  self._psum(valid.sum())
                  * bag.row_bytes() * (self.P - 1) // self.P)
        if not self.packed:
            _scount("collectives", len(bag.data) + 1)
            data = {n: self._all_gather(a) for n, a in bag.data.items()}
            v = self._all_gather(valid)
            return FlatBag(data, v)
        # packed: same single-collective column batching as exchange
        names = bag.columns
        lanes = [X._to_i64_bits(bag.data[n]) for n in names]
        lanes.append(valid.to(torch.int64))
        _scount("collectives")
        allmat = self._all_gather(torch.stack(lanes, dim=1))
        data = {n: X._from_i64_bits(allmat[:, i], bag.data[n].dtype)
                for i, n in enumerate(names)}
        return FlatBag(data, allmat[:, -1] != 0)

    # -- joins -----------------------------------------------------------
    def join(self, left: FlatBag, right: FlatBag, left_on, right_on,
             how: str = "inner", unique_right: bool = True,
             broadcast: bool = False, skew_aware: bool = False,
             expansion: float = 4.0,
             heavy_keys: Optional[torch.Tensor] = None) -> FlatBag:
        """``heavy_keys`` (compiler-planned skew, ``plans.SkewJoinP``)
        supplies the heavy-key set as a runtime value — a padded int64
        array bound per call — instead of the per-call sampling of
        ``skew_aware``. Both route through the same light-exchange +
        heavy-broadcast skew triple."""
        if broadcast:
            rall = self.gather_all(right)
            return self._local_join(left, rall, left_on, right_on, how,
                                    unique_right, expansion)
        if heavy_keys is not None:
            _scount("skew_join_planned")
            return self._skew_join(left, right, left_on, right_on, how,
                                   unique_right, expansion,
                                   heavy=heavy_keys)
        if skew_aware or self.skew_default:
            _scount("skew_join_sampled")
            return self._skew_join(left, right, left_on, right_on, how,
                                   unique_right, expansion)
        lk, rk = self._copartition_keys(left, right, left_on, right_on)
        lex = self._side_exchange(left, lk)
        rex = self._side_exchange(right, rk)
        return self._local_join(lex, rex, left_on, right_on, how,
                                unique_right, expansion)

    def _side_exchange(self, bag: FlatBag, key_cols,
                       keep: Optional[torch.Tensor] = None,
                       key: Optional[torch.Tensor] = None) -> FlatBag:
        """Exchange one join side on the co-partition key computed by
        ``_copartition_keys`` (None => already placed: elide)."""
        if key_cols is None:
            _scount("exchange_elided")
            return bag if keep is None else bag.mask(keep)
        return self.exchange(bag, key_cols, keep=keep, key=key)

    def _copartition_keys(self, left: FlatBag, right: FlatBag,
                          left_on, right_on):
        """Pick the exchange key for each join side so the two sides end
        up co-partitioned with as little movement as possible.

        A side already hash-partitioned on a positional sub-tuple of its
        join key can stay put; the OTHER side then exchanges on the
        *corresponding* sub-tuple (matching rows have equal values at
        those positions, hence the same hash). When both sides deliver
        the same positional selection, the join exchanges neither.
        Returns ``(left_key, right_key)`` with ``None`` meaning elide."""
        left_on, right_on = tuple(left_on), tuple(right_on)
        if not (self.packed and X.ORDER_AWARE):
            return left_on, right_on

        def sel(part, on):
            if not part:
                return None
            try:
                return tuple(on.index(c) for c in part)
            except ValueError:
                return None

        li = sel(left.props.partitioning, left_on)
        ri = sel(right.props.partitioning, right_on)
        if li is not None and ri is not None and li == ri:
            return None, None
        if li is not None:
            return None, tuple(right_on[i] for i in li)
        if ri is not None:
            return tuple(left_on[i] for i in ri), None
        return left_on, right_on

    def _local_join(self, left, right, left_on, right_on, how,
                    unique_right, expansion):
        if unique_right:
            return X.fk_join(left, right, left_on, right_on, how=how)
        out_cap = int(max(left.capacity, right.capacity)
                      * max(expansion, 1.0))
        bag, overflow = X.general_join(left, right, left_on, right_on,
                                       out_cap, how=how)
        self._add("overflow_rows", overflow)
        return bag

    def _skew_join(self, left, right, left_on, right_on, how,
                   unique_right, expansion, heavy=None):
        """Paper Fig. 6: split the probe side by heavy keys; exchange the
        light component; leave heavy probe rows in place and broadcast
        the matching build rows. Each key set is packed once and
        threaded through detection, split and exchange. ``heavy``
        (planned skew) supplies the key set directly — sorted here so
        any runtime binding order works with the searchsorted member
        test — replacing the sample + all_gather detection round."""
        left_on, right_on = tuple(left_on), tuple(right_on)
        lkey = X.pack_keys(left, left_on)
        if heavy is not None:
            hk = torch.sort(heavy.to(torch.int64)).values
        else:
            hk = self.heavy_keys(left, left_on, key=lkey)
        heavy_mask = SK.is_member(lkey, hk,
                                  use_kernel=self.use_kernel) & left.valid
        # light plan: standard exchange join (co-partition aware)
        lk, rk = self._copartition_keys(left, right, left_on, right_on)
        rkey = X.pack_keys(right, right_on)
        lex = self._side_exchange(left, lk, keep=~heavy_mask,
                                  key=lkey if lk == left_on else None)
        rex = self._side_exchange(right, rk,
                                  key=rkey if rk == right_on else None)
        light = self._local_join(lex, rex, left_on, right_on, how,
                                 unique_right, expansion)
        # heavy plan: heavy probe rows stay; broadcast matching build rows
        r_heavy = SK.is_member(rkey, hk, use_kernel=self.use_kernel)
        rall = self.gather_all(right, keep=r_heavy)
        heavy = self._local_join(left.mask(heavy_mask), rall, left_on,
                                 right_on, how, unique_right, expansion)
        return self._union_compact(light, heavy)

    def _union_compact(self, light: FlatBag, heavy: FlatBag) -> FlatBag:
        """Union the light/heavy results of a skew op. Packed mode
        compacts back to the larger of the two capacities (adaptively
        regrown when the valid counts demand more) instead of letting
        every skew op compound ``P*bucket + cap``; the padding that
        remains and any dropped rows are metered."""
        if not self.packed:
            return concat_bags(light, heavy)
        site, target = self._size_site(max(light.capacity, heavy.capacity))
        need = light.valid.to(torch.int64).sum() \
            + heavy.valid.to(torch.int64).sum()
        self._add_max(f"size_need_{site}", need)
        out, dropped = concat_compact(light, heavy, target)
        self._add("compact_dropped_rows", dropped)
        self._add("union_padding_rows", (target - need).clamp(min=0))
        return out

    # -- hypercube multiway join (one replicating round, plans.MultiJoinP)
    def multi_join(self, spine: FlatBag, rights: Sequence[FlatBag],
                   stages, shares: Sequence[int], rel_routes,
                   dim_heavy: Sequence[Optional[torch.Tensor]],
                   use_kernel: bool = False) -> FlatBag:
        """Span-traced wrapper; see ``_multi_join``."""
        with _span("exchange", kind="hypercube", shares=tuple(shares),
                   site=self._n_sites):
            return self._multi_join(spine, rights, stages, shares,
                                    rel_routes, dim_heavy, use_kernel)

    def _multi_join(self, spine: FlatBag, rights: Sequence[FlatBag],
                    stages, shares: Sequence[int], rel_routes,
                    dim_heavy: Sequence[Optional[torch.Tensor]],
                    use_kernel: bool = False) -> FlatBag:
        """One-round multiway equi-join (HyperCube shuffle). The mesh is
        factored into per-dimension ``shares``; every relation
        (``spine`` + ``rights``) is hashed on the dimensions it keys
        (``rel_routes``) and replicated across the rest, all relations
        ship in ONE packed collective, then the stages probe locally.

        Replication runs over VIRTUAL rows: source row ``i`` fans out to
        ``repl`` copies, copy ``q`` taking its missing-dimension
        coordinates from the mixed-radix digits of ``q``. Heavy keys
        (``dim_heavy[d]``, the runtime SkewJoinP parameter) spread probe
        rows across their dimension by row index and replicate the
        matching build rows along it — extra copies of light build rows
        are masked invalid, so the wire cost stays proportional to the
        heavy set."""
        rule = FAULTS.hit("dist.exchange", keys=("__hypercube__",))
        if rule is not None and rule.kind == "fail":
            raise ExchangeError("injected hypercube exchange failure")
        Pn = self.P
        n_dims = len(shares)
        shares = [int(s) for s in shares]
        # the plan's shares were chosen for ``skew_partitions`` servers;
        # if the runtime axis is smaller, shrink the largest shares
        # until the coordinate space fits (every hypercube coordinate
        # needs a server of its own for exactly-once results)
        while _prod(shares) > Pn:
            d = max(range(n_dims), key=lambda i: shares[i])
            shares[d] = max(1, shares[d] - 1)
        strides = [1] * n_dims
        for d in range(n_dims - 2, -1, -1):
            strides[d] = strides[d + 1] * shares[d + 1]
        hsorted = [None if h is None
                   else torch.sort(h.to(torch.int64)).values
                   for h in dim_heavy]
        bags = [spine] + list(rights)
        use_k = use_kernel or self.use_kernel

        sends, buckets, lane_n = [], [], []
        for r, bag in enumerate(bags):
            dev = bag.device
            route = {int(d): (tuple(cols), role)
                     for d, cols, role in rel_routes[r]}
            miss = [d for d in range(n_dims) if d not in route]
            hrep = [d for d in route
                    if route[d][1] == "build" and hsorted[d] is not None]
            rep_dims = miss + hrep
            repl = 1
            for d in rep_dims:
                repl *= shares[d]
            cap = bag.capacity
            V = cap * repl
            vi = torch.arange(V, device=dev)
            src = vi // repl
            # mixed-radix replica coordinates for the replicated dims
            qc: Dict[int, torch.Tensor] = {}
            rem = vi % repl
            for d in reversed(rep_dims):
                qc[d] = rem % shares[d]
                rem = rem // shares[d]
            ok = bag.valid[src]
            dest = torch.zeros(V, dtype=torch.int64, device=dev)
            for d in range(n_dims):
                sd = shares[d]
                if d in route:
                    cols, role = route[d]
                    key = X.pack_keys(bag, cols)
                    ch = mix64(key) % sd
                    hv = hsorted[d]
                    if role == "probe":
                        if hv is not None:
                            hm = SK.is_member(key, hv, use_kernel=use_k)
                            spread = torch.arange(cap, device=dev) % sd
                            ch = torch.where(hm, spread, ch)
                        coord = ch[src]
                    else:           # build side of dimension d
                        if hv is not None:
                            hm = SK.is_member(key, hv, use_kernel=use_k)
                            coord = qc[d]   # one copy per coordinate...
                            # ...heavy rows keep all of them, light rows
                            # only the hashed one
                            ok = ok & (hm[src] | (qc[d] == ch[src]))
                        else:
                            coord = ch[src]
                else:
                    coord = qc[d]
                dest = dest + coord * strides[d]

            route_v = self._route(torch.where(ok, dest, Pn))
            counts = route_v[1]
            site, bucket = self._size_site(
                max(int(V * self.cap_factor) // Pn, 1))
            self._add_max(f"size_need_{site}", counts.max())
            recv_c = self._psum(counts)
            self._add_max(f"part_max_{site}", recv_c.max())
            self._add(f"part_rows_{site}", counts.sum())
            sent = torch.minimum(counts, self._i64(bucket)).sum()
            self._add("overflow_rows", (counts - bucket).clamp(min=0).sum())
            self._add("shuffle_rows", sent)
            self._add("shuffle_bytes", sent * bag.row_bytes())
            # replication observability: actual extra copies crossing
            # the wire for this relation (static factor in SHUFFLE_STATS,
            # measured rows/bytes in the device metrics)
            _METRICS.set_gauge(f"shuffle.replication_x100_{site}",
                               repl * 100)
            n_src = bag.valid.to(torch.int64).sum()
            n_virt = ok.to(torch.int64).sum()
            self._add("replicated_rows", n_virt - n_src)
            self._add("bytes_replicated",
                      (n_virt - n_src) * bag.row_bytes())

            names = bag.columns
            lanes = [X._to_i64_bits(bag.data[nm]) for nm in names] \
                + [torch.ones(cap, dtype=torch.int64, device=dev)]
            sends.append(self._pack(lanes, route_v, bucket, V, use_k,
                                    repl=repl))
            del lanes, route_v, ok, dest, coord, qc, vi, src, rem
            buckets.append(bucket)
            lane_n.append(len(names) + 1)

        # -- ALL relations in ONE collective ---------------------------
        l_max = max(lane_n)
        parts = []
        for r, send in enumerate(sends):
            s3 = send.reshape(Pn, buckets[r], lane_n[r])
            if lane_n[r] < l_max:
                s3 = torch.cat([s3, s3.new_zeros(
                    (Pn, buckets[r], l_max - lane_n[r]))], dim=2)
            parts.append(s3)
        _scount("collectives")
        _scount("hypercube_exchanges")
        recv = self._all_to_all(torch.cat(parts, dim=1))
        del parts, sends, send, s3

        out_bags = []
        off = 0
        for r, bag in enumerate(bags):
            blk = recv[:, off:off + buckets[r], :].reshape(
                Pn * buckets[r], l_max)
            off += buckets[r]
            names = bag.columns
            data = {nm: X._from_i64_bits(blk[:, i], bag.data[nm].dtype)
                    for i, nm in enumerate(names)}
            out_bags.append(FlatBag(data, blk[:, len(names)] != 0))

        # -- local multiway probe (no further exchanges) ----------------
        acc = out_bags[0]
        for st, rb in zip(stages, out_bags[1:]):
            acc = self._local_join(acc, rb, tuple(st.left_on),
                                   tuple(st.right_on), "inner",
                                   st.unique_right, st.expansion)
        return acc

    # -- heavy-key detection (sampled, then gathered) ---------------------
    def heavy_keys(self, bag: FlatBag, key_cols,
                   key: Optional[torch.Tensor] = None) -> torch.Tensor:
        if key is None:
            key = X.pack_keys(bag, key_cols)
        local = SK.heavy_keys_local(key, bag.valid, sample=self.sample,
                                    threshold=self.threshold)
        self._add("broadcast_bytes", local.shape[0] * 8 * (self.P - 1))
        _scount("collectives")
        allc = self._all_gather(local)
        return SK.merge_heavy(allc)

    # -- aggregation -------------------------------------------------------
    def sum_by(self, bag: FlatBag, keys, vals, local_preagg: bool = True,
               use_kernel: bool = False,
               exchange_on: Optional[Sequence[str]] = None) -> FlatBag:
        """Gamma+ : optional local pre-aggregation (aggregation pushdown,
        §3.3 — executed "locally at each partition"), exchange by key,
        final local aggregation.

        ``exchange_on`` (planner hint, ``push_partitioning``) narrows
        the exchange key to a subset of the grouping keys — co-location
        on a subset is sufficient for grouping, and a well-chosen subset
        lets downstream consumers reuse the delivered partitioning."""
        keys = tuple(keys)
        if local_preagg:
            bag = X.sum_by(bag, keys, vals, use_kernel=use_kernel)
        ex_key = tuple(exchange_on) if exchange_on else keys
        assert set(ex_key) <= set(keys), (ex_key, keys)
        ex = self.exchange(bag, ex_key)
        return X.sum_by(ex, keys, vals, use_kernel=use_kernel)

    def dedup(self, bag: FlatBag, cols,
              exchange_on: Optional[Sequence[str]] = None) -> FlatBag:
        cols = tuple(cols)
        local = X.dedup(bag, cols)
        ex_key = tuple(exchange_on) if exchange_on else cols
        assert set(ex_key) <= set(cols), (ex_key, cols)
        ex = self.exchange(local, ex_key)
        return X.dedup(ex, cols)

    # -- BagToDict (skew-aware label repartition, Fig. 6 last row) --------
    def bag_to_dict(self, bag: FlatBag, skew_aware: bool = True) -> FlatBag:
        if not skew_aware:
            return self.exchange(bag, ("label",))
        key = X.pack_keys(bag, ("label",))
        hk = self.heavy_keys(bag, ("label",), key=key)
        heavy_mask = SK.is_member(key, hk,
                                  use_kernel=self.use_kernel) & bag.valid
        light = self.exchange(bag, ("label",), keep=~heavy_mask, key=key)
        heavy = bag.mask(heavy_mask)
        # heavy labels keep their current location (skew resilience);
        # compact the light+heavy union back toward pre-split capacity.
        return self._union_compact(light, heavy)


# ---------------------------------------------------------------------------
# running the sites: one thread per site
# ---------------------------------------------------------------------------

def _shard(bag: FlatBag, n: int, i: int) -> FlatBag:
    """Rows ``[i * cap / n, (i + 1) * cap / n)`` of ``bag`` as a bag with
    fresh physical props (the reference's ``in_specs=P(axis)``)."""
    s = bag.capacity // n
    return FlatBag({c: a[i * s:(i + 1) * s] for c, a in bag.data.items()},
                   bag.valid[i * s:(i + 1) * s])


def _concat_sites(outs: list) -> Dict[str, FlatBag]:
    """The sites' output bags concatenated in site order, column by
    column (the reference's ``out_specs=P(axis)``)."""
    return {k: FlatBag({c: torch.cat([o[k].data[c] for o in outs])
                        for c in bag.data},
                       torch.cat([o[k].valid for o in outs]))
            for k, bag in outs[0].items()}


def _signature(env: Dict[str, FlatBag], params: Dict[str, torch.Tensor]
               ) -> tuple:
    """What a ``jax.jit`` cache keys on: every input bag's columns,
    dtypes and capacity, and every parameter's dtype and shape — never
    the values."""
    bags = tuple((name, bag.capacity, str(bag.device),
                  tuple(sorted((c, str(a.dtype))
                               for c, a in bag.data.items())))
                 for name, bag in sorted(env.items()))
    ps = tuple((k, str(v.dtype), tuple(v.shape))
               for k, v in sorted(params.items()))
    return bags, ps


def run_on_sites(mesh: VirtualMesh, fn: Callable[[DistContext], object],
                 make_ctx: Optional[Callable] = None,
                 record: bool = False) -> list:
    """Run ``fn(ctx)`` once per site of ``mesh``, each on its own thread
    with its own ``DistContext`` (``make_ctx(site, rendezvous)``; by
    default a context of the mesh's axis on its device), and return the
    sites' results in site order. Only site 0 records host telemetry,
    and only when ``record`` is set. A site that raises aborts the
    others; the run then raises that site's own exception."""
    n = mesh.n
    dev = mesh.device
    if make_ctx is None:
        def make_ctx(site: int, rv: _Rendezvous) -> DistContext:
            return DistContext(mesh.axis, n, site=site, device=dev,
                               rendezvous=rv)
    rv = _Rendezvous(n)
    results: list = [None] * n
    errors: List[Optional[BaseException]] = [None] * n

    def work(i: int) -> None:
        cuda = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        try:
            with host_recording_as(record and i == 0), cuda:
                results[i] = fn(make_ctx(i, rv))
                rv.finish(i)
        except BaseException as e:       # re-raised below, after the join
            errors[i] = e
            rv.abort(e)

    threads = [threading.Thread(target=work, args=(i,), daemon=True,
                                name=f"mesh-site-{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=_WAIT_S * 4)
    if any(t.is_alive() for t in threads):
        err = CollectiveTimeout(f"a site of the mesh ran longer than "
                                f"{_WAIT_S * 4} s")
        rv.abort(err)
        raise err
    failed = [e for e in errors if e is not None]
    if failed:
        own = [e for e in failed if not isinstance(e, MeshAborted)]
        raise (own or failed)[0]
    return results


def _run_sites(mesh: VirtualMesh, make_ctx, fn, env: Dict[str, FlatBag],
               params: Optional[dict], record: bool):
    """Run ``fn(env_local, ctx[, params])`` once per site
    (``run_on_sites``); returns (the outputs concatenated in site order,
    site 0's combined metrics)."""
    n = mesh.n
    dev = mesh.device
    for k, b in env.items():
        if b.device != dev:
            raise ValueError(f"bag {k} lies on {b.device}; the mesh is on "
                             f"{dev}")
    shards = [{k: _shard(b, n, i) for k, b in env.items()}
              for i in range(n)]

    def site(ctx: DistContext) -> tuple:
        local = shards[ctx.site]
        out = fn(local, ctx) if params is None else fn(local, ctx, params)
        return out, ctx.finalize_metrics()

    results = run_on_sites(mesh, site, make_ctx, record)
    out = _concat_sites([r[0] for r in results])
    metrics = results[0][1]
    if metrics:
        keys = list(metrics)
        vals = torch.stack([metrics[k] for k in keys]).tolist()
        metrics = dict(zip(keys, (int(v) for v in vals)))
    return out, dict(metrics)


def _merge_host_stats(metrics: Dict[str, int],
                      stats: Dict[str, int]) -> Dict[str, int]:
    """Fold the compile-time SHUFFLE_STATS snapshot into device
    metrics."""
    metrics = dict(metrics)
    metrics["shuffle_collectives"] = stats.get("collectives", 0)
    metrics["exchanges"] = stats.get("exchanges", 0)
    metrics["exchanges_elided"] = stats.get("exchange_elided", 0)
    metrics["hypercube_exchanges"] = stats.get("hypercube_exchanges", 0)
    repl = [v for k, v in stats.items() if k.startswith("replication_x100_")]
    if repl:
        metrics["replication_factor_x100"] = max(repl)
    return metrics


class DistRunner:
    """A compiled distributed program with its capacity plan resolved.

    ``compile_distributed`` returns one of these after the adaptive
    sizing loop converges; calling it re-runs the SAME per-site program
    on the mesh with the resolved capacities (warm path: no host
    telemetry recorded, as a warm jitted call does not trace), which is
    the steady-state serving case. ``stats`` is the host-side
    SHUFFLE_STATS snapshot of the final compile attempt (collectives,
    elisions, per-site sizes) and is merged into every call's metrics.

    When the program was compiled with runtime parameters
    (``compile_distributed(params=...)``) a warm call may rebind them —
    ``runner(env, params=new_bindings)`` — with zero retracing as long
    as shapes/dtypes match (the skew heavy-key contract)."""

    def __init__(self, run, stats: Dict[str, int],
                 params: Optional[dict] = None):
        self._run = run
        self.stats = stats
        self.params = params        # compile-time bindings (None = none)

    def __call__(self, env, params: Optional[dict] = None
                 ) -> Tuple[dict, Dict[str, int]]:
        if self.params is None:
            assert params is None, (
                "program compiled without runtime parameters")
            out, metrics = self._run(env, None)
        else:
            p = dict(self.params)
            if params:
                unknown = set(params) - set(p)
                assert not unknown, (
                    f"unknown parameter(s) {sorted(unknown)}; this "
                    f"program binds {sorted(p)}")
                p.update(params)
            out, metrics = self._run(env, p)
        return out, _merge_host_stats(metrics, self.stats)


def _param_tensors(params: dict, device: torch.device) -> dict:
    from repro_torch.core.plans import as_scalar_tensor
    return {k: as_scalar_tensor(v, device) for k, v in params.items()}


def compile_distributed(
        fn: Callable[[Dict[str, FlatBag], DistContext], dict],
        env: Dict[str, FlatBag], mesh: VirtualMesh,
        axis: str = "data", cap_factor: float = 2.0,
        skew_default: bool = False,
        threshold: float = 0.025,
        jit: bool = True,
        shuffle_mode: str = "packed",
        use_kernel: bool = False,
        adaptive: bool = False,
        max_retries: int = 3,
        params: Optional[dict] = None
) -> Tuple[DistRunner, dict, Dict[str, int]]:
    """Run ``fn(env_local, ctx)`` on every site of ``mesh[axis]`` once.
    Returns ``(runner, outputs, metrics)`` — call ``runner`` again for
    warm executions of the same program.

    Every FlatBag in env is row-sharded over the sites (capacities must
    divide the number of sites); the outputs are concatenated in site
    order.

    ``params`` (optional) is a dict of runtime parameter values given to
    every site; when given, ``fn`` is called as ``fn(env_local, ctx,
    params_local)`` and warm runner calls may rebind new values of the
    same shapes with zero retracing.

    ``adaptive=True`` turns on adaptive capacity: the run records, per
    sizing site (exchange bucket / skew-union capacity), the true
    required size as a pmax metric; if any site was undersized the
    program is re-run with a ``size_plan`` pinning each such site to its
    exact need (rounded up to a multiple of 8), up to ``max_retries``
    times. Persistent overflow stays metered in ``overflow_rows`` /
    ``compact_dropped_rows``.

    Host-side counters (``SHUFFLE_STATS``) from the final attempt are
    merged into the returned metrics: ``shuffle_collectives``,
    ``exchanges``, ``exchanges_elided``. ``jit=False`` records them on
    every call, as an un-jitted shard_map traces on every call."""
    n = mesh.shape[axis]
    for k, b in env.items():
        assert b.capacity % n == 0, (
            f"bag {k} capacity {b.capacity} not divisible by {n} partitions")
    assert shuffle_mode in ("packed", "legacy"), shuffle_mode

    has_params = params is not None
    pvals = _param_tensors(params or {}, mesh.device)

    def make_ctx_for(plan):
        def make_ctx(site: int, rv: _Rendezvous) -> DistContext:
            return DistContext(axis, n, cap_factor=cap_factor,
                               sample=256, threshold=threshold,
                               skew_default=skew_default,
                               packed=(shuffle_mode == "packed"),
                               size_plan=plan, use_kernel=use_kernel,
                               site=site, device=mesh.device,
                               rendezvous=rv)
        return make_ctx

    size_plan: Optional[Tuple[int, ...]] = None
    attempt = 0
    while True:
        reset_shuffle_stats()
        out, metrics = _run_sites(mesh, make_ctx_for(size_plan), fn, env,
                                  pvals if has_params else None,
                                  record=True)
        host = dict(SHUFFLE_STATS)
        merged = _merge_host_stats(metrics, host)
        if not adaptive or shuffle_mode != "packed" \
                or attempt >= max_retries:
            break
        needs = {int(k.rsplit("_", 1)[1]): v for k, v in merged.items()
                 if k.startswith("size_need_")}
        used = {int(k.rsplit("_", 1)[1]): v for k, v in host.items()
                if k.startswith("size_used_")}
        grow = {s: v for s, v in needs.items() if v > used.get(s, v)}
        if not grow:
            break
        n_sites = max(used) + 1 if used else 0
        size_plan = tuple(
            _roundup8(grow[s]) if s in grow else used.get(s, 1)
            for s in range(n_sites))
        attempt += 1

    make_ctx = make_ctx_for(size_plan)
    seen = {_signature(env, pvals)}

    def run(env_, p):
        pv = _param_tensors(p, mesh.device) if p is not None else None
        sig = _signature(env_, pv or {})
        record = not jit or sig not in seen
        if jit:
            seen.add(sig)
        return _run_sites(mesh, make_ctx, fn, env_, pv, record)

    runner = DistRunner(run, host, pvals if has_params else None)
    return runner, out, merged


def run_distributed(fn: Callable[[Dict[str, FlatBag], DistContext], dict],
                    env: Dict[str, FlatBag], mesh: VirtualMesh,
                    **kwargs) -> Tuple[dict, Dict[str, int]]:
    """One-shot ``compile_distributed`` (see there for the knobs)."""
    _, out, metrics = compile_distributed(fn, env, mesh, **kwargs)
    return out, metrics
