"""Checkpoint / resume for cluster state and for the scenario fleet's carry.

Counterpart of ``ringpop_tpu/sim/snapshot.py``, file for file:

* :func:`save_state` / :func:`load_state` read and write the JAX package's
  own ``.npz`` format (the same ``__meta__`` record, magic, ``type`` and
  ``fields``), so a snapshot saved by either package loads into the other,
  for ``LifecycleState``, ``DeltaState`` and ``FullViewState``.  The leaves
  cross through each engine's ``state_to_numpy`` / ``state_from_numpy``:
  the file holds the JAX dtypes (packed planes and the key as uint32).
  Snapshots written before the packed engines (no ``ride_ok``, an unpacked
  bool ``learned``) are migrated on load as the JAX package migrates them.
* :func:`save_state_orbax` / :func:`load_state_orbax` and
  :func:`save_carry_orbax` / :func:`load_carry_orbax` (the fleet's nested
  carry: ``FleetSweep``'s batched engine state and telemetry counters) are
  the multi-process store that takes the place of the JAX package's orbax
  checkpoints (the card's machine has neither orbax nor tensorstore): a
  directory of npz files, one a writing rank, so a single process's
  checkpoint is one file.  Each rank writes only its own blocks (a sharded
  state's rows and word block, a fleet carry's batch rows: a
  ``partition.Shard`` or, with ``mesh=``, the table's layout), each tagged
  with its global offset and the leaf's global shape.  The leaves are
  named as the JAX package's ``_flatten_named`` names them
  (``states.learned``, ``telemetry.pings``: the path joined with ".") and
  hold the JAX dtypes, so a carry reads with numpy and compares leaf for
  leaf with the JAX sweep's.  ``torch.distributed`` barriers order the
  writes (the JAX package's orbax barriers).  A restore
  reads only the blocks that overlap its own, onto any process count or
  mesh shape (``shardings=``), and raises on a missing block, overlapping
  blocks, or a leaf whose global shape or dtype is not the target's.

Not ported yet, refused with NotImplementedError: the host-plane membership
export and import (``export_membership`` / ``import_membership``, which
need the host memberlist: A14).
"""

from __future__ import annotations

import glob
import json
import os
import warnings
from typing import Type, TypeVar

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device

T = TypeVar("T", bound=tuple)

_MAGIC = "ringpop_tpu-snapshot-v1"


def _engine(type_name: str):
    """The port's engine module of a state type name."""
    from ringpop_tpu_torch.sim import delta, fullview, lifecycle

    engines = {"LifecycleState": lifecycle, "DeltaState": delta, "FullViewState": fullview}
    if type_name not in engines:
        raise TypeError(f"no engine state named {type_name!r} (snapshots take {sorted(engines)})")
    return engines[type_name]


def save_state(path: str, state, params=None) -> None:
    """Write any engine state (a NamedTuple of tensors) to ``path`` (.npz)
    in the JAX package's format.  Works for DeltaState, FullViewState and
    LifecycleState alike.

    Pass the run's ``params`` when the engine has a dissemination bound
    (delta/lifecycle): the resolved ``max_p`` is persisted in the snapshot
    meta, so a later :func:`load_state` migration can rebuild derived
    planes without guessing the bound.  Params without one (the full-view
    engine's, on which the JAX package raises AttributeError) add
    nothing."""
    numpy_state = _engine(type(state).__name__).state_to_numpy(state)
    arrays = {f: np.asarray(v) for f, v in zip(state._fields, numpy_state)}
    meta_dict = {
        "magic": _MAGIC,
        "type": type(state).__name__,
        "fields": list(state._fields),
    }
    if params is not None and hasattr(params, "resolved_max_p"):
        from ringpop_tpu_torch.sim.delta import clamped_max_p

        meta_dict["max_p"] = int(clamped_max_p(params))
    meta = json.dumps(meta_dict)
    np.savez_compressed(path, __meta__=np.frombuffer(meta.encode(), dtype=np.uint8), **arrays)


def _pack_bool_np(bits: np.ndarray) -> np.ndarray:
    """bool[N, K] -> uint32[N, ceil(K/32)], the engines' packing."""
    from ringpop_tpu_torch.sim.packbits import pack_bool

    return pack_bool(torch.as_tensor(bits)).numpy().view(np.uint32)


def load_state(path: str, cls: Type[T], params=None, device: DeviceLike = None) -> T:
    """Load a snapshot written by :func:`save_state` (by either package)
    back into ``cls`` on ``device`` (the card unless the caller asks for the
    CPU).  Validates the engine type and field list before reconstructing.

    Migration: snapshots written before the round-3 packed engines carry no
    ``ride_ok`` plane.  Since it is derived state (== ``pack_bool(pcount <
    clamped_max_p)``), it is reconstructed here instead of refusing the
    load.  Pass the run's ``params`` when the snapshot was taken with a
    non-default ``p_factor``/``max_p`` — without it the bound stored in the
    snapshot's meta, else the default SWIM bound for the snapshot's n, is
    assumed.  A ``FullViewState`` takes its n from ``params`` or, without
    them, from its planes."""
    dev = resolve_device(device)
    engine = _engine(cls.__name__)
    with np.load(path) as data:
        if "__meta__" not in data.files:
            raise ValueError(f"{path}: not a ringpop_tpu snapshot")
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("magic") != _MAGIC:
            raise ValueError(f"{path}: not a ringpop_tpu snapshot")
        if meta["type"] != cls.__name__:
            raise ValueError(f"{path}: snapshot holds {meta['type']}, asked to load {cls.__name__}")
        saved = list(meta["fields"])
        want = list(cls._fields)
        migrate_ride = saved != want and [f for f in want if f != "ride_ok"] == saved
        if saved != want and not migrate_ride:
            raise ValueError(f"{path}: field mismatch {saved} != {want}")
        out = {f: np.asarray(data[f]) for f in saved}
    if migrate_ride:
        from ringpop_tpu_torch.sim.delta import INT8_SAFE_MAX_P, clamped_max_p, resolve_max_p
        from ringpop_tpu_torch.sim.packbits import n_words

        # pre-packing snapshots stored the boolean planes unpacked (bool[N,
        # K]); the packed engines expect uint32[N, ceil(K/32)]
        if "learned" in out and out["learned"].dtype == bool:
            out["learned"] = _pack_bool_np(out["learned"])
        if params is not None:
            max_p = clamped_max_p(params)
        elif "max_p" in meta:
            max_p = int(meta["max_p"])
        else:
            n = out["pcount"].shape[0]
            max_p = min(resolve_max_p(n, 15, None), INT8_SAFE_MAX_P)
            warnings.warn(
                f"{path}: migrating a pre-ride_ok snapshot without params; "
                f"assuming the default dissemination bound max_p={max_p} "
                f"for n={n} — pass the run's params if it used a custom "
                "p_factor/max_p, or the rebuilt ride gate will be wrong",
                stacklevel=2,
            )
        out["ride_ok"] = _pack_bool_np(out["pcount"] < np.int8(max_p))
        # post-migration structural check: every packed plane must now be
        # word-typed with ceil(K/32) words for pcount's K
        n, k = out["pcount"].shape
        for f in ("learned", "ride_ok"):
            if f in out and (out[f].dtype != np.uint32 or out[f].shape != (n, n_words(k))):
                raise ValueError(
                    f"{path}: migrated field {f!r} is "
                    f"{out[f].shape}/{out[f].dtype}, expected "
                    f"({n}, {n_words(k)})/uint32"
                )
    leaves = [out[f] for f in want]
    if cls.__name__ == "FullViewState":
        if params is None:
            params = engine.FullViewParams(n=int(out["status"].shape[0]))
        return engine.state_from_numpy(params, leaves, dev)
    return engine.state_from_numpy(leaves, dev)


def save_state_orbax(path: str, state, wait: bool = False, checkpointer=None, mesh=None):
    """Checkpoint an engine state into the multi-process store at ``path``
    (a directory): with ``mesh`` (a ``parallel.mesh.Mesh``), ``state`` is
    this rank's block and each rank writes its own blocks by the table
    (the planes' rows and word blocks, the per-node vectors' rows; leaves
    every rank holds whole, once), a collective over the job's processes;
    without one, the whole state (one writer).  Restore with
    :func:`load_state_orbax` onto any mesh shape.

    The write is synchronous: it is complete on every rank when this
    returns.  ``wait`` and ``checkpointer`` are accepted for the JAX
    package's signature (its orbax writer is asynchronous) and change
    nothing; returns None."""
    del wait, checkpointer
    engine = _engine(type(state).__name__)
    numpy_state = engine.state_to_numpy(state)
    tree = {f: np.asarray(v) for f, v in zip(state._fields, numpy_state)}
    if mesh is not None:
        from ringpop_tpu_torch.parallel.partition import place_blocks

        tree = place_blocks(tree, mesh)
    _write_store(path, {name: (leaf, _leaf_dtype(leaf)) for name, leaf in tree.items()},
                 {"type": type(state).__name__, "fields": list(state._fields)})


def load_state_orbax(path: str, example, shardings=None, device: DeviceLike = None):
    """Restore a :func:`save_state_orbax` checkpoint into ``type(example)``:
    ``example`` is a state of the GLOBAL shapes (tensors, or ``meta``
    tensors), whose field names and JAX dtypes the store must hold.
    ``shardings`` (a matching state of ``partition.NamedSharding``, e.g.
    ``lifecycle.state_shardings(mesh)``) restores this rank's block of every
    leaf under its spec, reading only the stored blocks that overlap it,
    whatever mesh wrote them; without it, the whole state.  The tensors go
    to ``device``, else the shardings' mesh's device, else the example's."""
    cls = type(example)
    table = _engine(cls.__name__)._LEAF_DTYPES
    # the JAX dtype of a leaf of the port's dtype; any other dtype is its own
    flat = {f: (leaf, np.dtype(table[f][0]) if leaf.dtype == table[f][1] else _leaf_dtype(leaf))
            for f, leaf in zip(cls._fields, example)}
    stored = sorted(_store_index(os.path.abspath(path)))
    if stored != sorted(cls._fields):
        raise ValueError(f"{path}: field mismatch {stored} != {sorted(cls._fields)} — wrong engine config?")
    sh = dict(zip(cls._fields, shardings)) if shardings is not None else {}
    return cls(**_read_store(path, flat, sh, device, "engine"))


# -- fleet carry checkpoints -----------------------------------------------------
#
# The fleet's resumable unit is a nested carry (batched engine state +
# batched telemetry counters).  The leaves are stored under the JAX
# package's "."-joined path names, in its dtypes; None legs are structure,
# not leaves (they round-trip through the example, not the file).


def _is_leaf(x) -> bool:
    """A carry leaf: a tensor, a numpy array, or a ``partition.Shard`` (a
    rank's block); a ``partition.NamedSharding`` is a leaf of a shardings
    tree."""
    from ringpop_tpu_torch.parallel.partition import NamedSharding, Shard

    return isinstance(x, (torch.Tensor, np.ndarray, Shard, NamedSharding))


def _leaf_dtype(leaf) -> np.dtype:
    from ringpop_tpu_torch.parallel.partition import NamedSharding, Shard

    if isinstance(leaf, NamedSharding):
        return np.dtype(np.int8)  # a shardings tree has no dtypes
    data = leaf.data if isinstance(leaf, Shard) else leaf
    if isinstance(data, torch.Tensor):
        return torch.empty((), dtype=data.dtype).numpy().dtype
    return np.asarray(data).dtype


def _numpy_dtype(owner, field: str, leaf) -> np.dtype:
    """The JAX package's dtype of a leaf: by its state's leaf table, else
    the leaf's own."""
    name = type(owner).__name__ if owner is not None else ""
    if name == "TelemetryState":
        return np.dtype(np.uint32 if field in ("piggybacked", "expired") else np.int32)
    if name in ("LifecycleState", "DeltaState", "FullViewState"):
        return np.dtype(_engine(name)._LEAF_DTYPES[field][0])
    return _leaf_dtype(leaf)


def _flatten_named(tree, prefix: str = "", owner=None, field: str = "") -> dict:
    """Carry -> flat {path-name: (leaf, JAX dtype)} in the JAX package's
    leaf order: dict keys sorted, NamedTuple and tuple fields in order, None
    skipped, names joined with ".".  A leaf is a tensor, a numpy array or a
    ``partition.Shard``."""
    if tree is None:
        return {}
    if _is_leaf(tree):
        return {prefix: (tree, _numpy_dtype(owner, field, tree))}
    out = {}
    if isinstance(tree, dict):
        items = [(str(k), v, None, "") for k, v in sorted(tree.items())]
    elif hasattr(tree, "_fields"):
        items = [(f, v, tree, f) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v, None, "") for i, v in enumerate(tree)]
    else:
        raise TypeError(f"a carry holds tensors, dicts, tuples and NamedTuples, got {type(tree).__name__}")
    for key, value, own, fld in items:
        for name, leaf in _flatten_named(value, f"{prefix}.{key}" if prefix else key, own, fld).items():
            if name in out:
                raise ValueError(f"carry flattens to duplicate leaf name {name!r}")
            out[name] = leaf
    return out


def _to_numpy(leaf, dtype: np.dtype) -> np.ndarray:
    arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    return arr.view(dtype) if arr.dtype.itemsize == dtype.itemsize else arr.astype(dtype)


def _from_numpy(arr: np.ndarray, like: torch.Tensor, dev: torch.device) -> torch.Tensor:
    want = torch.empty((), dtype=like.dtype).numpy().dtype
    arr = arr.view(want) if arr.dtype.itemsize == want.itemsize else arr.astype(want)
    return torch.as_tensor(np.array(arr), device=dev)


def _unflatten(example, leaves: dict, prefix: str = ""):
    if example is None:
        return None
    if isinstance(example, torch.Tensor):
        return leaves[prefix]
    join = (lambda k: f"{prefix}.{k}") if prefix else str
    if isinstance(example, dict):
        return {k: _unflatten(v, leaves, join(str(k))) for k, v in example.items()}
    if hasattr(example, "_fields"):
        return type(example)(*(_unflatten(v, leaves, join(f)) for f, v in zip(example._fields, example)))
    return type(example)(_unflatten(v, leaves, join(str(i))) for i, v in enumerate(example))


def save_carry_orbax(path: str, carry) -> None:
    """Checkpoint a nested carry into the multi-process store at ``path``
    (a directory), under ``_flatten_named``'s leaf names and the JAX dtypes.  A
    leaf may be a ``partition.Shard`` (this rank's block, from
    ``partition.fleet_shard_put`` or ``place_blocks``: written by its owner
    alone), or a tensor or numpy array (the whole leaf, written by process
    0).  A collective over the job's processes when there are several: the
    old store's files go, every owner writes its own, and a barrier
    follows.  Synchronous: the fleet sweep checkpoints at block boundaries
    and the kill-and-restore certificate needs the write complete before
    the run may die."""
    _write_store(path, _flatten_named(carry))


def load_carry_orbax(path: str, example, shardings=None, device: DeviceLike = None):
    """Restore a :func:`save_carry_orbax` checkpoint into the structure of
    ``example`` (a carry of tensors, or ``meta`` tensors, of the GLOBAL
    shapes; its None legs come back None).  ``shardings`` (a matching tree
    of ``partition.NamedSharding``, e.g. ``montecarlo.fleet_shardings``)
    restores this rank's block of each leaf, reading only the stored blocks
    that overlap it: a sweep saved at P processes resumes at P'.  Each leaf's
    global shape and dtype are checked against the example's."""
    flat_ex = _flatten_named(example)
    flat_sh = {name: sharding for name, (sharding, _) in _flatten_named(shardings).items()} if shardings else {}
    if flat_sh and sorted(flat_sh) != sorted(flat_ex):
        raise ValueError(f"shardings tree does not match the example carry: {sorted(flat_sh)} vs {sorted(flat_ex)}")
    return _unflatten(example, _read_store(path, flat_ex, flat_sh, device, "fleet"))


# -- the multi-process store ------------------------------------------------------
#
# <path>/shard-<rank>.npz, one file a writing rank: every leaf the rank owns
# under its name, and an "__index__" record with each leaf's global offset,
# global shape and dtype.  The files of an earlier save at the same path go
# first (process 0, before the first barrier), so a store never mixes two
# process counts' blocks.

_STORE_MAGIC = "ringpop_tpu_torch-store-v1"
_SHARD_GLOB = "shard-*.npz"


def _shard_file(path: str, rank: int) -> str:
    return os.path.join(path, f"shard-{rank:05d}.npz")


def _write_store(path: str, flat: dict, extra: dict | None = None) -> None:
    """Write this rank's owned leaves of ``flat`` ({name: (leaf, JAX
    dtype)}, a leaf a ``partition.Shard``, tensor or array) into the store
    at ``path``, between the job's barriers."""
    from ringpop_tpu_torch.parallel import multihost
    from ringpop_tpu_torch.parallel.partition import Shard

    path = os.path.abspath(path)
    rank = multihost.process_index()
    os.makedirs(path, exist_ok=True)
    if rank == 0:
        for old in glob.glob(os.path.join(path, _SHARD_GLOB + "*")):
            os.remove(old)
    multihost.barrier()
    arrays, index = {}, {}
    for name, (leaf, dtype) in flat.items():
        shard = leaf if isinstance(leaf, Shard) else Shard(leaf, (0,) * np.ndim(leaf), np.shape(leaf), rank == 0)
        if not shard.owner:
            continue
        arrays[name] = _to_numpy(shard.data, dtype)
        index[name] = {"offset": list(shard.offset), "shape": list(shard.shape), "dtype": np.dtype(dtype).str}
    if arrays:
        meta = json.dumps({"magic": _STORE_MAGIC, "leaves": index, **(extra or {})})
        tmp = f"{_shard_file(path, rank)}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, __index__=np.frombuffer(meta.encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, _shard_file(path, rank))
    multihost.barrier()


def _store_index(path: str) -> dict:
    """{leaf name: [(file, offset, block shape, global shape, dtype)]} over
    every file of the store."""
    files = sorted(glob.glob(os.path.join(path, _SHARD_GLOB)))
    if not files:
        raise ValueError(f"{path}: no checkpoint store here (no {_SHARD_GLOB} files)")
    pieces: dict = {}
    for file in files:
        with np.load(file) as data:
            meta = json.loads(bytes(data["__index__"]).decode())
            if meta.get("magic") != _STORE_MAGIC:
                raise ValueError(f"{file}: not a ringpop_tpu_torch checkpoint store file")
            for name, entry in meta["leaves"].items():
                block = tuple(data[name].shape) if name in data.files else None
                pieces.setdefault(name, []).append(
                    (file, tuple(entry["offset"]), block, tuple(entry["shape"]), np.dtype(entry["dtype"])))
    return pieces


def _overlap(a0, ashape, b0, bshape):
    """The intersection of two boxes as (start, stop) a axis, or None."""
    box = []
    for x0, xn, y0, yn in zip(a0, ashape, b0, bshape):
        lo, hi = max(x0, y0), min(x0 + xn, y0 + yn)
        if lo >= hi:
            return None
        box.append((lo, hi))
    return box


def _check_pieces(path: str, name: str, pieces: list, shape: tuple, dtype: np.dtype, what: str) -> None:
    """Raise ValueError unless the stored blocks of leaf ``name`` are one
    leaf of ``shape`` and ``dtype``, tiled with no block missing and none
    overlapping another."""
    got = {(p[3], p[4]) for p in pieces}
    if len(got) > 1:
        raise ValueError(f"{path}: the blocks of leaf {name!r} disagree on its shape and dtype: {sorted(got)}")
    gshape, gdtype = got.pop()
    if gshape != shape or gdtype != dtype:
        raise ValueError(f"{path}: leaf {name!r} is {gshape}/{gdtype}, expected {shape}/{dtype} — wrong {what} config?")
    for i, (file, off, block, _, _) in enumerate(pieces):
        if block is None or len(off) != len(shape) or any(
                o < 0 or o + b > g for o, b, g in zip(off, block, shape)):
            raise ValueError(f"{path}: {file} holds a bad block of leaf {name!r} (offset {off}, block {block})")
        for other in pieces[i + 1:]:
            if _overlap(off, block, other[1], other[2]) is not None:
                raise ValueError(f"{path}: overlapping blocks of leaf {name!r} in {file} and {other[0]}")
    if sum(int(np.prod(p[2])) for p in pieces) != int(np.prod(shape)):
        raise ValueError(f"{path}: leaf {name!r} has a missing block (a shard file is missing)")


def _read_store(path: str, flat: dict, shardings: dict, device: DeviceLike, what: str) -> dict:
    """{name: this rank's block of each leaf of ``flat`` ({name: (example
    leaf of the global shape, JAX dtype)}) as a tensor}: the block under
    ``shardings[name]`` (whole without one), assembled from the stored
    blocks that overlap it."""
    from ringpop_tpu_torch.parallel.partition import block_of

    path = os.path.abspath(path)
    index = _store_index(path)
    out, opened = {}, {}
    try:
        for name, (like, dtype) in flat.items():
            if name not in index:
                raise ValueError(f"{path}: leaf {name!r} is missing from the store — wrong {what} config?")
            shape = tuple(like.shape)
            _check_pieces(path, name, index[name], shape, np.dtype(dtype), what)
            sharding = shardings.get(name)
            if sharding is None:
                offset, block = (0,) * len(shape), shape
            else:
                offset, block, _ = block_of(sharding.spec, sharding.mesh, shape)
            arr = np.empty(block, dtype)
            for file, off, pblock, _, _ in index[name]:
                box = _overlap(offset, block, off, pblock)
                if box is None:
                    continue
                if file not in opened:
                    opened[file] = np.load(file)
                src = opened[file][name]
                arr[tuple(slice(lo - o, hi - o) for (lo, hi), o in zip(box, offset))] = \
                    src[tuple(slice(lo - o, hi - o) for (lo, hi), o in zip(box, off))]
            dev = device if device is not None else (
                sharding.mesh.device if sharding is not None else (None if like.device.type == "meta"
                                                                    else like.device))
            out[name] = _from_numpy(arr, like, resolve_device(dev))
    finally:
        for data in opened.values():
            data.close()
    return out


# -- host-plane membership export/import -------------------------------------


def export_membership(memberlist, path: str | None = None) -> list[dict]:
    """Refused: the membership change list needs the host memberlist, which
    the port has not copied yet (ROADMAP A14)."""
    raise NotImplementedError("membership export needs the host memberlist (ROADMAP Queue A14)")


def import_membership(memberlist, source) -> int:
    """Refused with :func:`export_membership` (ROADMAP A14)."""
    raise NotImplementedError("membership import needs the host memberlist (ROADMAP Queue A14)")
