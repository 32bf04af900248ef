"""The sim plane's node mesh over ``torch.distributed`` ranks.

Counterpart of ``ringpop_tpu/parallel/mesh.py``.  The JAX package
annotates its arrays and lets GSPMD partition one jitted ``step``.  PyTorch
has no partitioner that sees through the port's hand-written kernels, so
the port writes the partitioned tick itself, as one program per rank over
``torch.distributed`` (the multi-controller idiom of DDP and FSDP):

* the mesh is ``{"node": P, "rumor": 1}``: rank r owns the contiguous node
  rows ``partition.process_block(n, r, P)`` of every node-sharded leaf
  (the big planes and the per-node vectors), and holds the rumor table,
  the scalars and the key whole.  A rumor axis above 1 (word-sharded
  planes) is ROADMAP A12b;
* the engines read ``params.exchange_mesh``: with a mesh of more than one
  node rank the state they take and return is this rank's block, and the
  tick's cross-rank steps are the shift exchange's roll legs
  (``parallel/shift``), the row reduces' combines (``sim/packbits``), and
  a few gathers of per-node vectors and single rows (:class:`Mesh`'s
  collectives).

The transport is chosen by the caller, never by a fallback: ``"nccl"``
moves CUDA tensors between cards; ``"gloo"`` moves host tensors, so on the
card every leg is staged through host memory explicitly, and the staged
bytes are counted (``Mesh.stats``).  NCCL refuses two ranks on one card and
has no bitwise reduce, so the bitwise combines are an ``all_gather``
followed by a local reduce on both transports, and a single card runs its
ranks over gloo (``multihost.default_transport``).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Optional

import torch

from ringpop_tpu_torch.parallel.partition import NamedSharding, named_shardings, process_block

A12B = "ROADMAP A12b"
TRANSPORTS = ("nccl", "gloo")


def _dist():
    import torch.distributed as dist

    return dist


def _new_stats() -> dict:
    return {"collectives": 0, "collective_bytes": 0, "sends": 0, "send_bytes": 0, "staged_bytes": 0}


@dataclass(eq=False)
class Mesh:
    """P node ranks of one ``torch.distributed`` group, this process being
    ``rank``; its tensors live on ``device``.  ``stats`` counts what the
    collectives and sends moved (bytes as each rank sent them) and what was
    staged through host memory for gloo; :meth:`reset_stats` zeroes it."""

    size: int
    rank: int
    device: torch.device
    transport: str
    group: Optional[object] = None
    stats: dict = field(default_factory=_new_stats)

    @property
    def shape(self) -> dict:
        return {"node": self.size, "rumor": 1}

    @property
    def coords(self) -> dict:
        return {"node": self.rank, "rumor": 0}

    @property
    def sharded(self) -> bool:
        return self.size > 1

    def block(self, n: int) -> tuple[int, int]:
        """This rank's node rows [lo, hi) of an n-node leaf."""
        return process_block(n, self.rank, self.size)

    def reset_stats(self) -> None:
        for key in self.stats:
            self.stats[key] = 0

    def _peer(self, r: int) -> int:
        return r if self.group is None else _dist().get_global_rank(self.group, r)

    # -- staging ---------------------------------------------------------------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the transport takes it: contiguous, and on the host for
        gloo (a staged copy, counted)."""
        t = t.contiguous()
        if self.transport == "gloo" and t.is_cuda:
            self.stats["staged_bytes"] += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _home(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if t.device != like.device:
            self.stats["staged_bytes"] += t.numel() * t.element_size()
            return t.to(like.device)
        return t

    # -- collectives -------------------------------------------------------------

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[P, *t.shape]: every rank's ``t`` (same shape and dtype on every
        rank), in rank order, on ``t``'s device."""
        if not self.sharded:
            return t[None]
        dist = _dist()
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        self.stats["collectives"] += 1
        self.stats["collective_bytes"] += w.numel() * w.element_size()
        return self._home(torch.stack(parts), t)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global leaf from every rank's row block: blocks concatenated
        along axis 0."""
        g = self.all_gather(t)
        return g.reshape((g.shape[0] * g.shape[1],) + tuple(g.shape[2:]))

    def or_words(self, words: torch.Tensor, partials: bool = False):
        """Bitwise OR over ranks of an int32 word vector (one all_gather, then
        a local reduce: NCCL has no bitwise reduce).  With ``partials``,
        also every rank's own words, [P, *words.shape]."""
        g = self.all_gather(words)
        out = functools.reduce(torch.bitwise_or, g.unbind(0))
        return (out, g) if partials else out

    def and_words(self, words: torch.Tensor) -> torch.Tensor:
        """Bitwise AND over ranks of an int32 word vector."""
        return functools.reduce(torch.bitwise_and, self.all_gather(words).unbind(0))

    def rows_of(self, plane: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
        """[len(rows), *row]: the global rows ``rows`` (each in [0, n)) of a
        node-sharded integer plane, this rank's block being ``plane``: each
        owner supplies its rows, zeros elsewhere, and the ranks OR them."""
        lo, hi = self.block(n)
        rows = rows.to(torch.int64)
        own = (rows >= lo) & (rows < hi)
        local = plane[(rows - lo).clamp(0, hi - lo - 1)]
        mask = own.reshape(own.shape + (1,) * (local.dim() - 1))
        return self.or_words(torch.where(mask, local, torch.zeros_like(local)))

    # -- point to point ------------------------------------------------------------

    def exchange(self, sends: list, recvs: list) -> list:
        """Post every send ``(tensor, dst_rank, tag)`` and receive
        ``(like_tensor, src_rank, tag)`` at once, wait for all, and return
        the received tensors on ``like_tensor``'s device.  Every rank posts
        its operations in the same order (NCCL matches a pair's messages by
        order, gloo by tag)."""
        dist = _dist()
        ops, bufs = [], []
        for t, dst, tag in sends:
            w = self._wire(t)
            self.stats["sends"] += 1
            self.stats["send_bytes"] += w.numel() * w.element_size()
            ops.append(dist.P2POp(dist.isend, w, self._peer(dst), self.group, tag))
        for like, src, tag in recvs:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              device="cpu" if self.transport == "gloo" else like.device)
            bufs.append((buf, like))
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(src), self.group, tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [self._home(buf, like) for buf, like in bufs]


def make_mesh(n_devices: Optional[int] = None, shape: Optional[tuple[int, int]] = None,
              transport: Optional[str] = None, device=None, group=None) -> Mesh:
    """The ("node", "rumor") mesh over the ranks of ``group`` (the default
    group when None), which ``multihost.init_distributed`` brought up: one
    process a node rank.  ``n_devices`` (default: the group's size) must be
    the group's size; ``shape`` defaults to ``(P, 1)``, and a rumor axis
    above 1 is refused (A12b).  ``transport`` must be the group's backend
    (None takes it).  ``device`` defaults to ``cuda:{rank mod cards}`` when
    a card is visible (one card a rank under NCCL), else the CPU."""
    dist = _dist()
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed up (multihost.init_distributed)")
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n_devices is None:
        n_devices = size
    if n_devices != size:
        raise ValueError(f"a mesh of {n_devices} node ranks needs a group of that many processes, have {size}")
    if shape is None:
        shape = (size, 1)
    if shape[1] != 1:
        raise NotImplementedError(f"a rumor axis of {shape[1]} (word-sharded planes) is not ported yet ({A12B})")
    if shape[0] != size:
        raise ValueError(f"mesh shape {shape} does not cover the group's {size} ranks")
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
    return Mesh(size=size, rank=rank, device=dev, transport=transport, group=group)


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
    the mesh has one node rank (the whole state is the block).  ``h``
    (``exchange_h``) and ``pipelined`` (``exchange_pipelined``) are applied
    even when a mesh is already bound; the mesh itself is never rebound."""
    extra = {}
    if h is not None:
        extra["exchange_h"] = h
    if pipelined is not None:
        extra["exchange_pipelined"] = pipelined
    if params.exchange_mesh is not None:
        return dataclasses.replace(params, **extra) if extra else params
    if mesh.shape.get("node", 1) <= 1:
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


__all__ = ["Mesh", "NamedSharding", "make_mesh", "delta_shardings", "shard_delta_state", "with_exchange_mesh",
           "sharded_delta_step"]
