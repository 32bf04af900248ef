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
* :func:`save_carry` / :func:`load_carry` checkpoint the fleet's nested
  carry (``FleetSweep``: batched engine state and batched telemetry
  counters) as ONE ``.npz``, where the JAX package writes an orbax store.
  The leaves are named as the JAX package's ``_flatten_named`` names them
  (``states.learned``, ``telemetry.pings``: the path joined with ".") and
  hold the JAX dtypes, so the carry reads with numpy and compares leaf for
  leaf with the JAX sweep's.

Not ported yet, each refused with NotImplementedError: the orbax state
checkpoints (``save_state_orbax`` / ``load_state_orbax``, whose point is
sharded multi-process writes: ROADMAP A12) and the host-plane membership
export and import (``export_membership`` / ``import_membership``, which
need the host memberlist: A14).
"""

from __future__ import annotations

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


def save_state_orbax(path: str, state, wait: bool = False, checkpointer=None):
    """Refused: the orbax checkpoints exist for sharded, multi-process
    writes (ROADMAP A12).  :func:`save_state` writes the same state."""
    raise NotImplementedError("orbax state checkpoints (sharded, multi-process writes) are not ported yet "
                              "(ROADMAP Queue A12); save_state writes the npz snapshot")


def load_state_orbax(path: str, example, shardings=None):
    """Refused with :func:`save_state_orbax` (ROADMAP A12)."""
    raise NotImplementedError("orbax state checkpoints (sharded, multi-process reads) are not ported yet "
                              "(ROADMAP Queue A12); load_state reads the npz snapshot")


# -- fleet carry checkpoints -----------------------------------------------------
#
# The fleet's resumable unit is a nested carry (batched engine state +
# batched telemetry counters).  The leaves are stored under the JAX
# package's "."-joined path names, in its dtypes; None legs are structure,
# not leaves (they round-trip through the example, not the file).


def _numpy_dtype(owner, field: str, leaf: torch.Tensor) -> np.dtype:
    """The JAX package's dtype of a leaf: by its state's leaf table, else
    the tensor's own."""
    name = type(owner).__name__ if owner is not None else ""
    if name == "TelemetryState":
        return np.dtype(np.uint32 if field in ("piggybacked", "expired") else np.int32)
    if name in ("LifecycleState", "DeltaState", "FullViewState"):
        return np.dtype(_engine(name)._LEAF_DTYPES[field][0])
    return torch.empty((), dtype=leaf.dtype).numpy().dtype


def _flatten_named(tree, prefix: str = "", owner=None, field: str = "") -> dict:
    """Carry -> flat {path-name: (tensor, JAX dtype)} in the JAX package's
    leaf order: dict keys sorted, NamedTuple and tuple fields in order, None
    skipped, names joined with "."."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
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


def _to_numpy(leaf: torch.Tensor, dtype: np.dtype) -> np.ndarray:
    arr = leaf.detach().cpu().numpy()
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


def save_carry(path: str, carry) -> None:
    """Checkpoint a nested carry (the fleet's states + telemetry) as one
    ``.npz`` at exactly ``path`` (written to a temporary file and renamed,
    so a reader never sees half a checkpoint).  Synchronous: the fleet
    sweep checkpoints at block boundaries and the kill-and-restore
    certificate needs the write complete before the run may die."""
    arrays = {name: _to_numpy(leaf, dtype) for name, (leaf, dtype) in _flatten_named(carry).items()}
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_carry(path: str, example, device: DeviceLike = None):
    """Restore a :func:`save_carry` checkpoint into the structure of
    ``example`` (a carry of tensors of the right shapes), on ``device`` —
    the example's device when None: the restore target names the layout.
    Every leaf's shape and JAX dtype is validated against the example's."""
    flat_ex = _flatten_named(example)
    dev = resolve_device(device) if device is not None else (
        next(iter(flat_ex.values()))[0].device if flat_ex else resolve_device(None))
    leaves = {}
    with np.load(path) as data:
        for name, (like, dtype) in flat_ex.items():
            if name not in data.files:
                raise ValueError(f"{path}: carry leaf {name!r} is missing — wrong fleet config?")
            got = data[name]
            want_shape = tuple(like.shape)
            if got.shape != want_shape or got.dtype != dtype:
                raise ValueError(
                    f"{path}: carry leaf {name!r} is {got.shape}/{got.dtype}, expected "
                    f"{want_shape}/{dtype} — wrong fleet config?"
                )
            leaves[name] = _from_numpy(got, like, dev)
    return _unflatten(example, leaves)


def save_carry_orbax(path: str, carry) -> None:
    """Refused: the port writes the carry with :func:`save_carry` (one npz);
    the process-spanning orbax store is ROADMAP A12."""
    raise NotImplementedError("the orbax fleet carry (process-spanning, sharded) is not ported yet "
                              "(ROADMAP Queue A12); save_carry writes the npz carry")


def load_carry_orbax(path: str, example, shardings=None):
    """Refused with :func:`save_carry_orbax` (ROADMAP A12)."""
    raise NotImplementedError("the orbax fleet carry (process-spanning, sharded) is not ported yet "
                              "(ROADMAP Queue A12); load_carry reads the npz carry")


# -- host-plane membership export/import -------------------------------------


def export_membership(memberlist, path: str | None = None) -> list[dict]:
    """Refused: the membership change list needs the host memberlist, which
    the port has not copied yet (ROADMAP A14)."""
    raise NotImplementedError("membership export needs the host memberlist (ROADMAP Queue A14)")


def import_membership(memberlist, source) -> int:
    """Refused with :func:`export_membership` (ROADMAP A14)."""
    raise NotImplementedError("membership import needs the host memberlist (ROADMAP Queue A14)")
