"""The sim plane's ("node", "rumor") mesh over ``torch.distributed`` ranks.

Counterpart of ``ringpop_tpu/parallel/mesh.py``.  The JAX package
annotates its arrays and lets GSPMD partition one jitted ``step``.  PyTorch
has no partitioner that sees through the port's hand-written kernels, so
the port writes the partitioned tick itself, as one program per rank over
``torch.distributed`` (the multi-controller idiom of DDP and FSDP):

* the mesh is ``{"node": P, "rumor": R}`` over P·R ranks, rank ``p·R + r``
  at coordinates ``(p, r)`` (the JAX package's row-major
  ``devices.reshape(P, R)``).  The rank owns the contiguous node rows
  ``partition.process_block(n, p, P)`` of every node-sharded leaf (the big
  planes and the per-node vectors) and word block ``r`` of R of every
  packed plane (``learned``, ``ride_ok``, telemetry's ``piggybacked`` and
  ``expired``; slot block ``r`` of ``pcount``).  It holds the rumor table,
  the scalars and the key whole;
* the ranks that share ``r`` form the node axis' subgroup (a column of P
  ranks) and the ranks that share ``p`` the rumor axis' (a row of R); every
  collective and exchange names the axis it runs over;
* the engines read ``params.exchange_mesh``: with a mesh of more than one
  rank the state they take and return is this rank's block, and the
  tick's cross-rank steps are the shift exchange's roll legs
  (``parallel/shift``, over the node axis), the row reduces' combines
  (``sim/packbits``, over the node axis), a few gathers of per-node
  vectors and single rows (node axis), and the gathers of the [K]-axis
  vectors the tick needs whole (rumor axis).

The transport is chosen by the caller, never by a fallback: ``"nccl"``
moves CUDA tensors between cards; ``"gloo"`` moves host tensors, so on the
card every leg is staged through host memory explicitly, and the staged
bytes are counted (``Mesh.stats``, and per axis ``Mesh.axis_stats``).  NCCL
refuses two ranks on one card and has no bitwise reduce, so the bitwise
combines are an ``all_gather`` followed by a local reduce on both
transports, and a single card runs its ranks over gloo
(``multihost.default_transport``).

A fleet of independent replicas adds a third axis in front
(:class:`FleetMesh`, ``("batch", "node", "rumor")``): batch coordinate b
holds its block of the replicas, each stepped over the (P, R) mesh of b's
ranks, and the batch axis carries only the fleet's gathers.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Optional

import torch

from ringpop_tpu_torch.parallel.partition import NamedSharding, named_shardings, process_block

AXES = ("node", "rumor")
FLEET_AXES = ("batch", "node", "rumor")
TRANSPORTS = ("nccl", "gloo")


def _dist():
    import torch.distributed as dist

    return dist


def _new_stats() -> dict:
    return {"collectives": 0, "collective_bytes": 0, "sends": 0, "send_bytes": 0, "staged_bytes": 0}


def _new_axis_stats() -> dict:
    return {axis: _new_stats() for axis in AXES}


@dataclass(eq=False)
class Mesh:
    """A (P, R) mesh of one ``torch.distributed`` group, this process at
    node coordinate ``rank`` of ``size`` (P) and rumor coordinate
    ``rumor_rank`` of ``rumor_size`` (R); its tensors live on ``device``.
    ``group`` holds the P·R ranks, ``node_group`` the P of this rank's
    column and ``rumor_group`` the R of its row (None where the axis has
    one rank; with R = 1 the node axis is ``group`` itself).  ``stats``
    counts what the collectives and sends moved (bytes as each rank sent
    them) and what was staged through host memory for gloo, and
    ``axis_stats`` the same by axis; :meth:`reset_stats` zeroes both."""

    size: int
    rank: int
    device: torch.device
    transport: str
    # the groups and the counters stay out of the repr, which keys the warm
    # start's programs (util/aot.py) and so must not change with them
    group: Optional[object] = field(default=None, repr=False)
    rumor_size: int = 1
    rumor_rank: int = 0
    node_group: Optional[object] = field(default=None, repr=False)
    rumor_group: Optional[object] = field(default=None, repr=False)
    stats: dict = field(default_factory=_new_stats, repr=False)
    axis_stats: dict = field(default_factory=_new_axis_stats, repr=False)

    @property
    def shape(self) -> dict:
        return {"node": self.size, "rumor": self.rumor_size}

    @property
    def coords(self) -> dict:
        return {"node": self.rank, "rumor": self.rumor_rank}

    @property
    def sharded(self) -> bool:
        """More than one rank on some axis."""
        return self.size * self.rumor_size > 1

    def block(self, n: int) -> tuple[int, int]:
        """This rank's node rows [lo, hi) of an n-node leaf."""
        return process_block(n, self.rank, self.size)

    def col_block(self, width: int) -> tuple[int, int]:
        """This rank's block [lo, hi) of a rumor-sharded axis of ``width``
        (words of a packed plane, slots of ``pcount``)."""
        if width % self.rumor_size:
            raise ValueError(f"an axis of {width} does not divide over {self.rumor_size} rumor ranks")
        b = width // self.rumor_size
        return self.rumor_rank * b, (self.rumor_rank + 1) * b

    def reset_stats(self) -> None:
        for stats in (self.stats, *self.axis_stats.values()):
            for key in stats:
                stats[key] = 0

    def _count(self, axis: str, key: str, amount: int) -> None:
        self.stats[key] += amount
        self.axis_stats[axis][key] += amount

    def _axis_size(self, axis: str) -> int:
        return self.size if axis == "node" else self.rumor_size

    def _axis_group(self, axis: str):
        if axis == "node":
            return self.group if self.rumor_size == 1 else self.node_group
        return self.rumor_group

    def _peer(self, coord: int, axis: str) -> int:
        """The global rank of this rank's neighbour at ``coord`` along
        ``axis`` (for point-to-point operations on ``group``)."""
        r = coord * self.rumor_size + self.rumor_rank if axis == "node" else self.rank * self.rumor_size + coord
        return r if self.group is None else _dist().get_global_rank(self.group, r)

    # -- staging ---------------------------------------------------------------

    def _wire(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` as the transport takes it: contiguous, and on the host for
        gloo (a staged copy, counted)."""
        t = t.contiguous()
        if self.transport == "gloo" and t.is_cuda:
            self._count(axis, "staged_bytes", t.numel() * t.element_size())
            return t.cpu()
        return t

    def _home(self, t: torch.Tensor, like: torch.Tensor, axis: str) -> torch.Tensor:
        if t.device != like.device:
            self._count(axis, "staged_bytes", t.numel() * t.element_size())
            return t.to(like.device)
        return t

    # -- collectives -------------------------------------------------------------

    def all_gather(self, t: torch.Tensor, axis: str = "node") -> torch.Tensor:
        """[ranks of the axis, *t.shape]: every rank's ``t`` along ``axis``
        (same shape and dtype on every rank), in coordinate order, on
        ``t``'s device.  A bool tensor crosses as bytes."""
        if self._axis_size(axis) == 1:
            return t[None]
        if t.dtype == torch.bool:
            return self.all_gather(t.to(torch.uint8), axis).to(torch.bool)
        dist = _dist()
        w = self._wire(t, axis)
        parts = [torch.empty_like(w) for _ in range(self._axis_size(axis))]
        dist.all_gather(parts, w, group=self._axis_group(axis))
        self._count(axis, "collectives", 1)
        self._count(axis, "collective_bytes", w.numel() * w.element_size())
        return self._home(torch.stack(parts), t, axis)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global leaf from every node rank's row block: blocks
        concatenated along axis 0."""
        g = self.all_gather(t)
        return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))

    def gather_cols(self, t: torch.Tensor) -> torch.Tensor:
        """Every rumor rank's block of the last axis (words or slots),
        concatenated in order: the whole rumor axis of this rank's rows."""
        if self.rumor_size == 1:
            return t
        return torch.cat(list(self.all_gather(t, "rumor").unbind(0)), dim=-1)

    def or_words(self, words: torch.Tensor, partials: bool = False, axis: str = "node"):
        """Bitwise OR over the ranks of ``axis`` of an int32 word vector (one
        all_gather, then a local reduce: NCCL has no bitwise reduce).  With
        ``partials``, also every rank's own words, [ranks, *words.shape]."""
        g = self.all_gather(words, axis)
        out = functools.reduce(torch.bitwise_or, g.unbind(0))
        return (out, g) if partials else out

    def and_words(self, words: torch.Tensor, axis: str = "node") -> torch.Tensor:
        """Bitwise AND over the ranks of ``axis`` of an int32 word vector."""
        return functools.reduce(torch.bitwise_and, self.all_gather(words, axis).unbind(0))

    def rows_of(self, plane: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
        """[len(rows), *row]: the global rows ``rows`` (each in [0, n)) of a
        node-sharded integer plane, this rank's block being ``plane`` (its
        own columns): each node rank supplies its rows, zeros elsewhere,
        and the node axis ORs them."""
        lo, hi = self.block(n)
        rows = rows.to(torch.int64)
        own = (rows >= lo) & (rows < hi)
        local = plane[(rows - lo).clamp(0, hi - lo - 1)]
        mask = own.reshape(own.shape + (1,) * (local.dim() - 1))
        return self.or_words(torch.where(mask, local, torch.zeros_like(local)))

    # -- point to point ------------------------------------------------------------

    def exchange(self, sends: list, recvs: list, axis: str = "node") -> list:
        """Post every send ``(tensor, dst, tag)`` and receive ``(like_tensor,
        src, tag)`` at once (``dst`` and ``src`` coordinates along
        ``axis``, the other coordinate this rank's), wait for all, and
        return the received tensors on ``like_tensor``'s device.  Every
        rank posts its operations in the same order (NCCL matches a pair's
        messages by order, gloo by tag)."""
        dist = _dist()
        ops, bufs = [], []
        for t, dst, tag in sends:
            w = self._wire(t, axis)
            self._count(axis, "sends", 1)
            self._count(axis, "send_bytes", w.numel() * w.element_size())
            ops.append(dist.P2POp(dist.isend, w, self._peer(dst, axis), self.group, tag))
        for like, src, tag in recvs:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if self.transport == "gloo" else like.device)
            bufs.append((buf, like))
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(src, axis), self.group, tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [self._home(buf, like, axis) for buf, like in bufs]


def _bring_up(what: str, n_devices: Optional[int], transport: Optional[str], device, group):
    """The group a mesh spans, checked: (size, rank, transport, device,
    global rank of a group rank).  ``n_devices`` must be the group's size and
    ``transport`` its backend (None takes it); ``device`` defaults to
    ``cuda:{rank mod cards}`` when a card is visible, else the CPU."""
    dist = _dist()
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs torch.distributed up (multihost.init_distributed)")
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} ranks needs a group of that many processes, have {size}")
    backend = str(dist.get_backend(group)).lower()
    if transport is None:
        transport = backend
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; one of {TRANSPORTS}")
    if transport != backend:
        raise ValueError(f"transport {transport!r} differs from the process group's backend {backend!r}")
    if device is None:
        device = f"cuda:{rank % torch.cuda.device_count()}" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if transport == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl transport moves CUDA tensors; use gloo for a CPU mesh")
        torch.cuda.set_device(dev)

    def global_rank(q: int) -> int:
        return q if group is None else dist.get_global_rank(group, q)

    return size, rank, transport, dev, global_rank


def _new_group(ranks: list, timeout: timedelta):
    return _dist().new_group(ranks, timeout=timeout)


def _axis_groups(ranks: list, p_size: int, r_size: int, coords, timeout: timedelta, mine: bool = True):
    """The node and rumor subgroups of a (P, R) block of global ``ranks``
    (row-major): the R columns, then the P rows, each made on every rank of
    the job in this order (an axis of one rank gets none; with R = 1 the
    node axis is the block's own group).  Returns this rank's (node group,
    rumor group) at ``coords`` (p, r) when ``mine``, else (None, None)."""
    p, r = coords
    kept = {}
    if r_size > 1:
        if p_size > 1:
            for col in range(r_size):
                g = _new_group([ranks[q * r_size + col] for q in range(p_size)], timeout)
                if col == r:
                    kept["node"] = g
        for row in range(p_size):
            g = _new_group([ranks[row * r_size + q] for q in range(r_size)], timeout)
            if row == p:
                kept["rumor"] = g
    if not mine:
        return None, None
    return kept.get("node"), kept.get("rumor")


def make_mesh(n_devices: Optional[int] = None, shape: Optional[tuple[int, int]] = None,
              transport: Optional[str] = None, device=None, group=None) -> Mesh:
    """The ("node", "rumor") mesh over the ranks of ``group`` (the default
    group when None), which ``multihost.init_distributed`` brought up: one
    process a rank, rank ``p·R + r`` at (p, r).  ``n_devices`` (default: the
    group's size) must be the group's size; ``shape`` (P, R) defaults to
    ``(size, 1)`` and must cover the group.  A collective: every rank
    builds the axes' subgroups in one fixed order (``dist.new_group``: the
    R columns, then the P rows; an axis of one rank gets none).
    ``transport`` must be the group's backend (None takes it).  ``device``
    defaults to ``cuda:{rank mod cards}`` when a card is visible (one card a
    rank under NCCL), else the CPU."""
    from ringpop_tpu_torch.parallel import multihost

    size, rank, transport, dev, global_rank = _bring_up("make_mesh", n_devices, transport, device, group)
    if shape is None:
        shape = (size, 1)
    p_size, r_size = (int(x) for x in shape)
    if p_size < 1 or r_size < 1 or p_size * r_size != size:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover the group's {size} ranks")
    p, r = divmod(rank, r_size)
    timeout = timedelta(seconds=multihost.group_timeout_s())
    node_group, rumor_group = _axis_groups([global_rank(q) for q in range(size)], p_size, r_size, (p, r), timeout)
    return Mesh(size=p_size, rank=p, device=dev, transport=transport, group=group, rumor_size=r_size,
                rumor_rank=r, node_group=node_group, rumor_group=rumor_group)


@dataclass(eq=False)
class FleetMesh:
    """A ("batch", "node", "rumor") mesh of Bm·P·R ranks for a fleet of
    independent replicas: rank ``b·P·R + p·R + r`` sits at batch coordinate
    ``b``, node ``p`` and rumor ``r`` (the JAX package's row-major
    ``devices.reshape(Bm, P, R)``).  ``inner`` is the (P, R) :class:`Mesh` of
    this rank's batch group, the P·R ranks that share ``b``: each replica
    of the group's block of the batch steps over it.  ``batch`` is the
    batch axis as a one-axis :class:`Mesh` of the Bm ranks that share
    ``(p, r)``: replicas are independent, so it carries no collective inside
    a tick, only the fleet's gathers (detection flags, telemetry records,
    digests, whole-fleet reads).  ``axis_stats`` counts each axis'
    collectives and bytes, ``stats`` their sum."""

    batch: Mesh
    inner: Mesh

    @property
    def shape(self) -> dict:
        return {"batch": self.batch.size, **self.inner.shape}

    @property
    def coords(self) -> dict:
        return {"batch": self.batch.rank, **self.inner.coords}

    @property
    def device(self) -> torch.device:
        return self.inner.device

    @property
    def transport(self) -> str:
        return self.inner.transport

    @property
    def sharded(self) -> bool:
        return self.batch.size > 1 or self.inner.sharded

    @property
    def axis_stats(self) -> dict:
        return {"batch": self.batch.axis_stats["node"], **self.inner.axis_stats}

    @property
    def stats(self) -> dict:
        out = _new_stats()
        for stats in self.axis_stats.values():
            for key, v in stats.items():
                out[key] += v
        return out

    def reset_stats(self) -> None:
        self.batch.reset_stats()
        self.inner.reset_stats()

    def block(self, b: int) -> tuple[int, int]:
        """This rank's replicas [lo, hi) of a fleet of ``b``."""
        return self.batch.block(b)


def make_fleet_mesh(shape: Optional[tuple[int, int, int]] = None, transport: Optional[str] = None, device=None,
                    group=None) -> FleetMesh:
    """The fleet's (Bm, P, R) mesh over the ranks of ``group`` (the default
    group when None): ``shape`` defaults to ``(size, 1, 1)``, every rank a
    batch coordinate.  Without ``torch.distributed`` up, the one-rank mesh
    (1, 1, 1).  A collective when it makes subgroups: every rank of the job
    makes, in this order, each batch group's (its P·R ranks, when Bm > 1
    and P·R > 1), each batch group's node and rumor subgroups
    (``make_mesh``'s order), then the batch axis' group of each (p, r);
    with P·R = 1 the batch axis is the group itself.  ``transport`` and
    ``device`` as ``make_mesh``'s."""
    from ringpop_tpu_torch.parallel import multihost

    dist = _dist()
    if not dist.is_initialized():
        if shape not in (None, (1, 1, 1)):
            raise RuntimeError("a fleet mesh of more than one rank needs torch.distributed up "
                               "(multihost.init_distributed)")
        dev = torch.device(device if device is not None else ("cuda" if torch.cuda.is_available() else "cpu"))
        one = {"device": dev, "transport": transport or "gloo"}
        return FleetMesh(batch=Mesh(size=1, rank=0, **one), inner=Mesh(size=1, rank=0, **one))
    size, rank, transport, dev, global_rank = _bring_up("make_fleet_mesh", None, transport, device, group)
    if shape is None:
        shape = (size, 1, 1)
    b_size, p_size, r_size = (int(x) for x in shape)
    if min(b_size, p_size, r_size) < 1 or b_size * p_size * r_size != size:
        raise ValueError(f"fleet mesh shape {tuple(shape)} does not cover the group's {size} ranks")
    block = p_size * r_size
    b, q = divmod(rank, block)
    p, r = divmod(q, r_size)
    timeout = timedelta(seconds=multihost.group_timeout_s())
    ranks = [global_rank(x) for x in range(size)]
    inner_group = group if b_size == 1 else None
    if b_size > 1 and block > 1:
        for bb in range(b_size):
            g = _new_group(ranks[bb * block:(bb + 1) * block], timeout)
            if bb == b:
                inner_group = g
    node_group = rumor_group = None
    for bb in range(b_size):
        got = _axis_groups(ranks[bb * block:(bb + 1) * block], p_size, r_size, (p, r), timeout, mine=bb == b)
        if bb == b:
            node_group, rumor_group = got
    batch_group = group if block == 1 else None
    if b_size > 1 and block > 1:
        for x in range(block):
            g = _new_group([ranks[bb * block + x] for bb in range(b_size)], timeout)
            if x == q:
                batch_group = g
    inner = Mesh(size=p_size, rank=p, device=dev, transport=transport, group=inner_group, rumor_size=r_size,
                 rumor_rank=r, node_group=node_group, rumor_group=rumor_group)
    return FleetMesh(batch=Mesh(size=b_size, rank=b, device=dev, transport=transport, group=batch_group),
                     inner=inner)


def delta_shardings(mesh: Mesh):
    """A ``DeltaState`` of ``NamedSharding`` (mesh, spec), one a leaf, from
    the canonical rule table (``partition.PARTITION_RULES``)."""
    from ringpop_tpu_torch.sim.delta import DeltaState

    return named_shardings(DeltaState(learned=0, pcount=0, ride_ok=0, tick=0, key=0), mesh)


def shard_delta_state(state, mesh: Mesh):
    """This rank's block of a whole ``DeltaState`` (``partition.shard_put``)."""
    from ringpop_tpu_torch.parallel.partition import shard_put

    return shard_put(state, mesh, state.learned.shape[0])


def with_exchange_mesh(params, mesh: Mesh, h: Optional[int] = None, pipelined: Optional[bool] = None):
    """``params`` with ``exchange_mesh`` bound to ``mesh`` (DeltaParams and
    LifecycleParams alike): the engines then take and return this rank's
    block and run the shift exchange's roll legs as ``parallel/shift``'s
    sub-block sends.  A no-op when the caller already bound a mesh, or when
    the mesh has one rank (the whole state is the block).  ``h``
    (``exchange_h``) and ``pipelined`` (``exchange_pipelined``) are applied
    even when a mesh is already bound; the mesh itself is never rebound."""
    extra = {}
    if h is not None:
        extra["exchange_h"] = h
    if pipelined is not None:
        extra["exchange_pipelined"] = pipelined
    if params.exchange_mesh is not None:
        return dataclasses.replace(params, **extra) if extra else params
    if not mesh.sharded:
        return params
    return dataclasses.replace(params, exchange_mesh=mesh, **extra)


def sharded_delta_step(params, mesh: Mesh):
    """The delta ``step`` bound to ``mesh`` (``with_exchange_mesh``): a
    callable ``(state_block, faults) -> state_block``, bit-equal to the
    unsharded step on the gathered state."""
    from ringpop_tpu_torch.sim.delta import step
    from ringpop_tpu_torch.sim.packbits import check_rumor_shardable

    check_rumor_shardable(params.k, mesh.shape.get("rumor", 1))
    return functools.partial(step, with_exchange_mesh(params, mesh))


__all__ = ["AXES", "FLEET_AXES", "FleetMesh", "Mesh", "NamedSharding", "make_mesh", "make_fleet_mesh",
           "delta_shardings", "shard_delta_state", "with_exchange_mesh", "sharded_delta_step"]
