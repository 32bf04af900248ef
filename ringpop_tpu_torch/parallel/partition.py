"""Canonical per-leaf partition rules for every sim-plane state.

Counterpart of ``ringpop_tpu/parallel/partition.py``: one ordered list of
``(leaf-name regex, spec)`` rules, matched against the "/"-joined path name
of every leaf (first match wins; no match replicates).  A spec here is a
:class:`P`, a tuple of mesh axis names or None per array axis — the port's
own stand-in for ``jax.sharding.PartitionSpec``.

Placement and gather over a :class:`parallel.mesh.Mesh` of (P, R) ranks:

* :func:`shard_put` gives this rank's block of every node-sharded leaf
  (``process_block`` rows of its node axis) and, of the per-(node, rumor)
  planes, its block of the rumor axis too (words of the packed planes,
  slots of ``pcount``); every other leaf whole, on the mesh's device.  The
  [K] rumor-table vectors (``r_subject``, ``r_inc``, ``r_status``,
  ``r_deadline``, ``timer_fires``) stay whole on every rank: the table's
  spec names the rumor axis, as the JAX package's does, but the port's
  tick reads it whole, and a replicated copy is bit-equal and simpler;
* :func:`host_gather` is its inverse, a collective: every plane's word or
  slot blocks ``all_gather``-ed over the rumor axis, every node-sharded
  leaf over the node axis, as host numpy; the rumor-table vectors are
  this rank's copy (counted once);
* :func:`process_block` is the ownership rule, contiguous equal blocks in
  rank order, with the same divisibility error.

Digest partials: ``telemetry.tree_digest`` is, per leaf, a wrapping uint32
sum of ``mix32(value ^ mix32(flat index))``, so :func:`leaf_partial_sums`
over each node rank's rows at their GLOBAL flat indices (kernel D1 on the
card, its ``offset`` being ``lo * row_elems`` mod 2**32) add up exactly,
and :func:`combine_leaf_partials` applies the digest's outer mix to the
sum.  A rank's [rows, W/R] word block is not one contiguous flat range, so
the digest first gathers a plane's row block over the rumor axis
(``Mesh.gather_cols``) and takes the partial of whole rows; D1 stays one
contiguous range a launch.

A fleet's [B, ...] leaves take the batch prefix (``partition_spec(tree,
batch_axes=1, batch_axis="batch")``).  :func:`fleet_shard_put` tags this
process's block of the batch with its global offset as a :class:`Shard`
(what the multi-process checkpoint store writes), and
:func:`fleet_host_gather` returns a rank's own rows, touching no other
rank's.  :func:`place_blocks` does the same for a rank's blocks on any
mesh, by the table (:func:`block_of`: which mesh axis splits each array
axis, and which rank of the ranks holding one block writes it).

This module imports torch; ``parallel/__init__.py`` does not import it.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

M32 = 0xFFFF_FFFF


class P(tuple):
    """A partition spec: one mesh axis name (or None) per array axis;
    ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A spec bound to a mesh: where one leaf lives."""

    mesh: object
    spec: P


# -- the table ----------------------------------------------------------------

# Ordered (regex, spec) rules matched against "/"-joined path names (first
# match wins; a leaf no rule matches replicates).  Names cover DeltaState,
# LifecycleState, TelemetryState, DeltaFaults, chaos.FaultPlan, and any
# dict/NamedTuple nesting of them — the JAX package's table, rule for rule.
PARTITION_RULES: list[tuple[str, P]] = [
    # big per-(node, rumor) planes: packed planes shard words, unpacked
    # planes slots (packbits.check_rumor_shardable is the k rule)
    (r"(^|/)(learned|pcount|ride_ok|piggybacked|expired)$", P("node", "rumor")),
    # topology tier ids int32[TIER_LEVELS, N]: the node axis is last
    (r"(^|/)(tier_ids)$", P(None, "node")),
    # per-node vectors (engine state, telemetry masks, fault legs); the
    # per-tier suspicion counters [N, N_TIERS] shard their node axis
    (
        r"(^|/)(base_status|base_inc|base_present|base_pending|base_deadline"
        r"|self_inc|pings|ping_reqs|probes_failed|incarnation_bumps"
        r"|base_timer_fires|up|base_up|group|drop_node|crash_tick"
        r"|restart_tick|flap_period|flap_phase|flap_down"
        r"|suspects_by_tier|false_suspects_by_tier)$",
        P("node"),
    ),
    # rumor-table vectors
    (r"(^|/)(r_subject|r_inc|r_status|r_deadline|timer_fires)$", P("rumor")),
    # everything else replicates: tick/key scalars, decl_* placement
    # vectors, heal_attempts, drop_rate, part_from/part_until, reach[G, G],
    # the [4] tier_drop table and the suspect_ticks scalar
]


def spec_for(name: str) -> P:
    """The canonical spec for a leaf path name (first rule wins; no match
    replicates)."""
    for pattern, spec in PARTITION_RULES:
        if re.search(pattern, name):
            return spec
    return P()


# -- trees: NamedTuples, dataclasses, tuples, lists, dicts; None is empty ------


def _children(tree):
    """(name, child) pairs of a tree node, in the JAX package's pytree
    order (fields in order, dict keys sorted), or None for a leaf."""
    if isinstance(tree, P):
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def named_leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path name, leaf) for every leaf, None skipped, in pytree order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += named_leaves(child, f"{prefix}/{name}" if prefix else name)
    return out


def _tree_map_named(fn, tree, prefix: str = ""):
    """``tree`` rebuilt with ``fn(name, leaf)`` at every leaf (None stays)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    vals = [_tree_map_named(fn, child, f"{prefix}/{name}" if prefix else name) for name, child in kids]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*vals)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{name: v for (name, _), v in zip(kids, vals)})
    if isinstance(tree, dict):
        return {k: v for k, v in zip(sorted(tree), vals)}
    return type(tree)(vals)


def partition_spec(tree, batch_axes: int = 0, batch_axis: Optional[str] = None):
    """The tree with a :class:`P` at every leaf, from the canonical table.
    ``batch_axes`` prepends that many axes to every spec (a fleet's [B, ...]
    batch), replicated, or the first over ``batch_axis`` when named."""

    return _tree_map_named(lambda name, _leaf: batched_spec(name, batch_axes, batch_axis), tree)


def batched_spec(name: str, batch_axes: int = 0, batch_axis: Optional[str] = None) -> P:
    """The table's spec of leaf ``name`` with ``batch_axes`` leading axes,
    the first over ``batch_axis`` when named, else replicated."""
    spec = spec_for(name)
    if not batch_axes:
        return spec
    return P(batch_axis, *([None] * (batch_axes - 1)), *spec)


def named_shardings(tree, mesh, batch_axes: int = 0, batch_axis: Optional[str] = None):
    """The tree with a :class:`NamedSharding` over ``mesh`` at every leaf
    (only the structure and leaf names of ``tree`` are read)."""
    specs = partition_spec(tree, batch_axes=batch_axes, batch_axis=batch_axis)
    return _tree_map_named(lambda _name, spec: NamedSharding(mesh, spec), specs)


def _axis_of(spec: P, name: str) -> Optional[int]:
    for i, ax in enumerate(spec):
        if ax == name or (isinstance(ax, tuple) and name in ax):
            return i
    return None


def _node_axis(spec: P) -> Optional[int]:
    return _axis_of(spec, "node")


def _plane_rumor_axis(spec: P) -> Optional[int]:
    """The rumor axis of a per-(node, rumor) plane's spec; None for a leaf
    with no node axis (the [K] rumor-table vectors, held whole)."""
    return _axis_of(spec, "rumor") if _node_axis(spec) is not None else None


# -- process-block ownership --------------------------------------------------


def process_block(n: int, rank: int, nprocs: int) -> tuple[int, int]:
    """Node rows [lo, hi) owned by ``rank`` of ``nprocs``: contiguous equal
    blocks in rank order.  ``n`` must divide evenly."""
    if n % nprocs:
        raise ValueError(
            f"n={n} must divide over {nprocs} processes (pad n or change the "
            f"process count; GSPMD imposes the same divisibility on the mesh path)"
        )
    block = n // nprocs
    if not 0 <= rank < nprocs:
        raise ValueError(f"rank {rank} outside [0, {nprocs})")
    return rank * block, (rank + 1) * block


# -- placement: whole or local leaves -> this rank's blocks --------------------


def shard_put(tree, mesh, global_n: int, batch_axes: int = 0):
    """This rank's placement of ``tree`` on ``mesh.device``: every
    node-sharded leaf cut to the rank's ``process_block`` rows of its node
    axis (a leaf whose node axis already holds the block is taken as it
    is), and every per-(node, rumor) plane also cut to the rank's block of
    its rumor axis, which it must hold whole (``Mesh.col_block``); every
    other leaf whole.  Leaves may be tensors or numpy arrays."""
    lo, hi = process_block(global_n, mesh.rank, mesh.size)
    rumor = mesh.shape.get("rumor", 1)

    def place(name, leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        spec = spec_for(name)
        if batch_axes:
            spec = P(*([None] * batch_axes), *spec)
        ax = _node_axis(spec)
        if ax is not None and t.dim() > ax:
            size = t.shape[ax]
            if size == global_n:
                t = t.narrow(ax, lo, hi - lo)
            elif size != hi - lo:
                raise ValueError(f"leaf {name!r}: node axis of {size} is neither n={global_n} nor the "
                                 f"block of {hi - lo}")
        rax = _plane_rumor_axis(spec)
        if rumor > 1 and rax is not None and t.dim() > rax:
            c0, c1 = mesh.col_block(t.shape[rax])
            t = t.narrow(rax, c0, c1 - c0)
        return t.to(mesh.device).clone()

    return _tree_map_named(place, tree)


def host_gather(tree, mesh, batch_axes: int = 0, spec: Optional[P] = None):
    """The inverse of :func:`shard_put`, a collective every rank calls
    with a tree of the same structure: every per-(node, rumor) plane's
    blocks gathered over the rumor axis, and every node-sharded leaf over
    the node axis, into the global array, as host numpy of the tensor's
    dtype; other leaves (the rumor-table vectors among them) are this
    rank's copy.  ``spec`` overrides the table for every leaf
    (``P("node")`` for a bare per-node block, such as
    ``lifecycle.view_checksums`` under a mesh)."""

    def gather(name, leaf):
        spec_ = spec_for(name) if spec is None else spec
        if batch_axes:
            spec_ = P(*([None] * batch_axes), *spec_)
        if not isinstance(leaf, torch.Tensor):
            return np.asarray(leaf)
        t = leaf
        rax = _plane_rumor_axis(spec_)
        if rax is not None and t.dim() > rax and mesh.shape.get("rumor", 1) > 1:
            t = torch.cat(list(mesh.all_gather(t.contiguous(), "rumor")), dim=rax)
        ax = _node_axis(spec_)
        if ax is not None and t.dim() > ax and mesh.size > 1:
            t = torch.cat(list(mesh.all_gather(t.contiguous())), dim=ax)
        return t.detach().cpu().numpy()

    return _tree_map_named(gather, tree)


# -- blocks with their global place: the checkpoint store's unit ---------------


class Shard:
    """One rank's block of a global leaf, as the multi-process checkpoint
    store writes it: ``data`` (a tensor or a numpy array), ``offset`` (where
    it starts in the global leaf, one int an axis), ``shape`` (the global
    leaf's) and ``owner`` (whether this rank writes it: of the ranks that
    hold the same block, one does)."""

    __slots__ = ("data", "offset", "shape", "owner")

    def __init__(self, data, offset: Sequence[int], shape: Sequence[int], owner: bool = True):
        self.data = data
        self.offset = tuple(int(x) for x in offset)
        self.shape = tuple(int(x) for x in shape)
        self.owner = bool(owner)

    def __repr__(self) -> str:
        return f"Shard(offset={self.offset}, shape={self.shape}, owner={self.owner}, block={tuple(self.data.shape)})"


def _split_axes(spec: P, mesh, ndim: int) -> list:
    """Per array axis of an ``ndim``-axis leaf of ``spec``, the mesh axis
    that splits it on ``mesh`` (None: whole on every rank): the batch and
    node axes where the mesh has more than one rank on them, the rumor axis
    only on a plane (the port holds the rumor-table vectors whole)."""
    sizes = mesh.shape
    plane_rumor = _plane_rumor_axis(spec)
    out = []
    for i in range(ndim):
        ax = spec[i] if i < len(spec) else None
        if ax in ("batch", "node") and sizes.get(ax, 1) > 1:
            out.append(ax)
        elif ax == "rumor" and i == plane_rumor and sizes.get("rumor", 1) > 1:
            out.append(ax)
        else:
            out.append(None)
    return out


def block_of(spec: P, mesh, shape: Sequence[int]) -> tuple[tuple, tuple, bool]:
    """(offset, block shape, owner) of this rank's block of a global leaf of
    ``shape`` laid out by ``spec`` on ``mesh`` (a ``Mesh`` or a
    ``FleetMesh``): every split axis in ``process_block``'s contiguous equal
    blocks (which must divide), every other axis whole.  ``owner``: this
    rank is at coordinate 0 of every mesh axis that does not split the
    leaf, so each block has one writer."""
    axes = _split_axes(spec, mesh, len(shape))
    coords, sizes = mesh.coords, mesh.shape
    offset, block = [], []
    for g, ax in zip(shape, axes):
        lo, hi = (0, int(g)) if ax is None else process_block(int(g), coords[ax], sizes[ax])
        offset.append(lo)
        block.append(hi - lo)
    owner = all(coords[ax] == 0 for ax, size in sizes.items() if size > 1 and ax not in axes)
    return tuple(offset), tuple(block), owner


def global_shape_of(spec: P, mesh, block: Sequence[int]) -> tuple:
    """The global shape of a leaf whose block on this rank has shape
    ``block`` (the inverse of :func:`block_of`'s block shape)."""
    axes = _split_axes(spec, mesh, len(block))
    return tuple(int(b) * (1 if ax is None else mesh.shape[ax]) for b, ax in zip(block, axes))


def place_blocks(tree, mesh, batch_axes: int = 0):
    """Every leaf of ``tree`` (this rank's blocks on ``mesh``, tensors or
    numpy arrays) as a :class:`Shard`: its global shape and offset by the
    table (``batch_axes`` leading batch axes, the first over the mesh's
    ``"batch"`` axis where it has one)."""
    batch_axis = "batch" if "batch" in mesh.shape else None

    def place(name, leaf):
        spec = batched_spec(name, batch_axes, batch_axis)
        shape = global_shape_of(spec, mesh, tuple(leaf.shape))
        offset, _, owner = block_of(spec, mesh, shape)
        return Shard(leaf, offset, shape, owner)

    return _tree_map_named(place, tree)


def fleet_shard_put(local_tree, mesh, global_b: int):
    """This process's slice of a fleet, placed on the batch axis of
    ``mesh`` (``montecarlo.fleet_save_mesh``): every leaf of ``local_tree``
    is ``[B_local, ...]``, the ``process_block(global_b, rank, nprocs)``
    rows of a ``[global_b, ...]`` fleet leaf, and comes back as
    :func:`place_blocks` places it, a :class:`Shard` at its global row
    offset, so that the checkpoint store writes each process's rows from
    that process alone.  A mesh that puts rows this process does not hold
    on its rank (its batch axis does not follow process order) raises
    ValueError, as the JAX package's does.  Single-process, the local
    slice is the whole fleet."""
    from ringpop_tpu_torch.parallel import multihost

    if "batch" not in mesh.shape:
        raise ValueError("fleet_shard_put places a fleet's batch axis: the mesh needs a 'batch' axis "
                         "(montecarlo.fleet_save_mesh)")
    nprocs = multihost.process_count()
    lo = process_block(global_b, multihost.process_index(), nprocs)[0] if nprocs > 1 else 0
    start, stop = (x - lo for x in mesh.block(global_b))

    def local_rows(_name, leaf):
        if start < 0 or stop > leaf.shape[0]:
            raise ValueError(
                "mesh places non-local fleet rows on this rank — the mesh's batch axis does not follow "
                "process_block order (build it with montecarlo.fleet_save_mesh)")
        return leaf[start:stop]

    return place_blocks(_tree_map_named(local_rows, local_tree), mesh, batch_axes=1)


def fleet_host_gather(tree):
    """The inverse of :func:`fleet_shard_put`: per leaf, this rank's own
    contiguous rows as host numpy (a :class:`Shard`'s block, a tensor's or
    an array's values); it never reads another rank's."""

    def gather(_name, leaf):
        if isinstance(leaf, Shard):
            leaf = leaf.data
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().cpu().numpy()
        return np.asarray(leaf)

    return _tree_map_named(gather, tree)


# -- digest partials ----------------------------------------------------------


def leaf_partial_sums(tree, lo: int = 0, include_replicated: bool = True) -> torch.Tensor:
    """int64[L] holding uint32: per leaf, the digest's inner sum over this
    block, node-sharded leaves (node axis 0, every other axis whole: gather
    a word block's columns first) at global flat indices from
    ``lo * row_elems`` (mod 2**32, as the JAX package's offset wraps);
    other leaves contribute only with ``include_replicated`` (one rank).
    Summing every rank's vector and :func:`combine_leaf_partials` gives the
    whole tree's ``tree_digest``.  D1 on the card."""
    from ringpop_tpu_torch.sim.telemetry import leaf_digest_sum

    out = []
    dev = None
    for name, leaf in named_leaves(tree):
        leaf = torch.as_tensor(leaf)
        dev = leaf.device
        sharded = _node_axis(spec_for(name)) == 0
        if not sharded and not include_replicated:
            out.append(torch.zeros((), dtype=torch.int64, device=dev))
            continue
        row_elems = int(math.prod(leaf.shape[1:])) if leaf.dim() else 0
        offset = (lo * row_elems) & M32 if sharded else 0
        out.append(leaf_digest_sum(leaf, offset=offset).to(torch.int64))
    if not out:
        return torch.zeros(0, dtype=torch.int64)
    return torch.stack(out)


def combine_leaf_partials(partials: Sequence) -> int:
    """Fold per-rank partial vectors (each L uint32 values) into the global
    ``tree_digest``: per-leaf wrapping sum across ranks, then the digest's
    outer per-leaf mix and accumulate.  Host numpy."""
    rows = [np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p).astype(np.int64) & M32 for p in partials]
    total = np.zeros_like(rows[0])
    for p in rows:
        total = (total + p) & M32
    acc = 0
    for li, leaf_sum in enumerate(total.tolist()):
        acc = (acc + _mix32(leaf_sum ^ ((li * 0x9E37_79B9) & M32))) & M32
    return acc


def _mix32(x: int) -> int:
    """murmur3 fmix32 on a Python int (the digest's outer mix)."""
    x &= M32
    x ^= x >> 16
    x = (x * 0x85EB_CA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2_AE35) & M32
    return x ^ (x >> 16)
