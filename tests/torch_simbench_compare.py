"""Row-for-row comparison of a simbench record from the JAX package with the
port's, for the ``tests/test_torch_simbench_*.py`` files.

:func:`assert_rows_match` demands the same keys at every level and equal
values everywhere except at the paths a test names as inexact, each with
its reason (a wall, a rate, a path, a description of the mesh's devices).
A path is dotted (``"detect.sharded_s"``); ``"*"`` matches any one key, so
``"scale.*.wall_s"`` names the field under every key of ``scale``.  A list
of dicts is compared element by element under the same path.
"""

from __future__ import annotations

import fnmatch
import json

# fields every row's record leaves out: ``main`` sets them, the tests call
# the row functions directly
ROW_FIELDS = ("bench", "platform", "full_scale", "wall_s")


def _inexact(path: str, skip) -> bool:
    return any(fnmatch.fnmatchcase(path, pat) and pat.count(".") == path.count(".") for pat in skip)


def _walk(want, got, path: str, skip, diffs: list) -> None:
    if path and _inexact(path, skip):
        return
    if isinstance(want, dict) and isinstance(got, dict):
        if set(want) != set(got):
            diffs.append(f"{path or '<record>'}: keys {sorted(want)} != {sorted(got)}")
            return
        for key in want:
            _walk(want[key], got[key], f"{path}.{key}" if path else str(key), skip, diffs)
        return
    if isinstance(want, (list, tuple)) and isinstance(got, (list, tuple)) and any(
            isinstance(x, dict) for x in want):
        if len(want) != len(got):
            diffs.append(f"{path}: {len(want)} items != {len(got)}")
            return
        for a, b in zip(want, got):
            _walk(a, b, path, skip, diffs)
        return
    if type(want) is not type(got):
        diffs.append(f"{path}: {type(want).__name__} {want!r} != {type(got).__name__} {got!r}")
    elif want != got:
        diffs.append(f"{path}: {want!r} != {got!r}")


def assert_rows_match(want: dict, got: dict, inexact: dict) -> None:
    """``want`` (the JAX row) and ``got`` (the port's) equal but at the
    ``inexact`` paths (path -> reason).  Neither record may carry an
    ``error``."""
    for rec in (want, got):
        assert "error" not in rec and rec.get("ok", True), rec
    assert all(reason for reason in inexact.values()), "every inexact field needs its reason"
    diffs: list = []
    # as ``main`` prints them: JSON types (a tuple is a list)
    want, got = json.loads(json.dumps(want)), json.loads(json.dumps(got))
    _walk(want, got, "", tuple(inexact), diffs)
    assert not diffs, "\n".join(diffs)
