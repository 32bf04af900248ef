"""The warm start: a process reloads what an earlier one built and starts
warm (counterpart of ``ringpop_tpu/util/aot.py``, the same front door and
record).

The port has no compiled program to serialize.  A program's "compile" is
the ``nvcc`` build of the hand-written kernel libraries it launches, their
load and their first launch; its Python runs as it is.  So the artifact is
a manifest, ``<tag>-<key>.json`` under :func:`default_cache_dir`, naming
by their build keys the kernel libraries one run of the program launched:

* a **miss** runs the program once, on copies of its inputs (the first
  call of every kernel it launches builds and loads that kernel's
  library), records the libraries whose wrappers launched, and writes the
  manifest; ``compile_s`` is that build and warm-up time;
* a **hit**, in a fresh process, loads exactly those libraries from the
  build cache (``util/accel.compile_cache_dir``) without running ``nvcc``;
  ``compile_s`` is the load time.

Both paths return a runner that calls the same function, so a hit is
bit-identical to a miss by construction.

The key (:func:`signature_key`) is the tag, the statics' reprs, each input
leaf's dtype, shape and device, a toolchain fingerprint (torch, CUDA,
numpy, Python and ``nvcc --version``: :func:`toolchain_fp8`) and a
fingerprint of the port's source, every ``.py`` file and every
``csrc/*.cu`` kernel (:func:`source_fp8`): an edited engine or kernel is
never served as a hit.

Where the JAX package falls back to its plain jit path — an unwritable
cache directory, a corrupt manifest, inputs whose structure or leaves drift
from the keyed ones — the port runs the same function uncached and says
why in ``info["error"]``.  That is the same kernel path: nothing here
switches a card's tensors to the plain PyTorch version, and a failure to
build or launch a kernel raises as it would without the front door.

Under a ``torch.distributed`` group of more than one process each rank
keys its own manifest (its rank and the group's size are statics), and the
ranks call the front door in step, as they call the engines.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import logging
import os
import time
from pathlib import Path
from typing import Callable, Optional

log = logging.getLogger("ringpop_tpu_torch.aot")

MANIFEST_FORMAT = "ringpop_tpu_torch.aot/1"
# the kernel wrappers of the port (ringpop_tpu_torch.ops.<name>): each has
# SOURCE, BUILD_DIR, launches and _library()
KERNEL_MODULES = ("hash_kernel", "packbits_kernel", "lifecycle_kernel", "threefry_kernel", "fullview_kernel",
                  "telemetry_kernel")
_PKG = Path(__file__).resolve().parent.parent


def _kernel_module(name: str):
    if name not in KERNEL_MODULES:
        raise ValueError(f"{name!r} is not a kernel module of the port")
    return importlib.import_module(f"ringpop_tpu_torch.ops.{name}")


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, ``<module>.<kernel>``."""
    out = {}
    for name in KERNEL_MODULES:
        counts = _kernel_module(name).launches
        if isinstance(counts, dict):
            out.update({f"{name}.{k}": v for k, v in counts.items()})
        else:
            out[name] = counts
    return out


def toolchain_fp8() -> str:
    """8-hex digest of the toolchain: ``telemetry.toolchain_fingerprint``
    (torch, CUDA, numpy, Python) and ``nvcc --version``."""
    from ringpop_tpu_torch.ops import _cuda_build
    from ringpop_tpu_torch.sim.telemetry import toolchain_fingerprint

    fp = {**toolchain_fingerprint(), "nvcc": _cuda_build.nvcc_version()}
    return hashlib.sha256(json.dumps(fp, sort_keys=True).encode()).hexdigest()[:8]


_SOURCE_FP8: Optional[str] = None


def source_fp8() -> str:
    """8-hex digest of the port's source: every ``.py`` file and every
    ``csrc/*.cu`` kernel, path-keyed.  Memoized per process."""
    global _SOURCE_FP8
    if _SOURCE_FP8 is None:
        h = hashlib.sha256()
        for root, dirs, files in sorted(os.walk(_PKG)):
            dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "_build"))
            for f in sorted(files):
                if not (f.endswith(".py") or (f.endswith(".cu") and os.path.basename(root) == "csrc")):
                    continue
                path = os.path.join(root, f)
                h.update(os.path.relpath(path, _PKG).encode())
                try:
                    with open(path, "rb") as fh:
                        h.update(fh.read())
                except OSError:  # a racing edit or removal
                    h.update(b"?")
        _SOURCE_FP8 = h.hexdigest()[:8]
    return _SOURCE_FP8


def default_cache_dir(create: bool = True) -> str:
    """``<build dir>/aot``: the manifests live beside the libraries they
    name (``_cuda_build.build_dir()``), under the same card and toolchain
    fingerprint.  ``$RINGPOP_TPU_AOT_CACHE`` names another base, keyed by
    the same fingerprint."""
    from ringpop_tpu_torch.ops import _cuda_build
    from ringpop_tpu_torch.util import accel

    base = os.environ.get("RINGPOP_TPU_AOT_CACHE")
    root = accel.compile_cache_dir(base, create=create) if base else str(_cuda_build.build_dir())
    path = os.path.join(root, "aot")
    if create:
        os.makedirs(path, exist_ok=True)
    return path


# -- trees of inputs: tuples (NamedTuples keep their type), lists, dicts and
# dataclass instances (``DeltaFaults``) are containers, None is an empty
# subtree, anything else is a leaf


def _children(tree) -> Optional[list]:
    """(name, child) pairs of a container, None for a leaf."""
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _flatten(tree, leaves: list) -> str:
    if tree is None:
        return "None"
    children = _children(tree)
    if children is None:
        leaves.append(tree)
        return "*"
    return f"{type(tree).__name__}(" + ",".join(f"{k!r}:{_flatten(x, leaves)}" for k, x in children) + ")"


def flatten(tree) -> tuple[list, str]:
    """(the leaves, the structure) of ``tree``."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _map_tensors(tree, fn):
    """``tree`` with ``fn`` applied to every tensor leaf."""
    import torch

    if isinstance(tree, torch.Tensor):
        return fn(tree)
    children = _children(tree)
    if not children:
        return tree
    mapped = {k: _map_tensors(x, fn) for k, x in children}
    if isinstance(tree, tuple):
        return type(tree)(*mapped.values()) if hasattr(tree, "_fields") else tuple(mapped.values())
    if isinstance(tree, list):
        return list(mapped.values())
    if isinstance(tree, dict):
        return mapped
    if all(mapped[k] is x for k, x in children):
        return tree
    return dataclasses.replace(tree, **mapped)


def _leaf_descriptor(leaf) -> str:
    """One input leaf's part of the key: a tensor's dtype, shape and device,
    an array's dtype and shape, else its type (a Python scalar is a value
    of the program, not part of its identity)."""
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        return f"{str(leaf.dtype).removeprefix('torch.')}{list(leaf.shape)}@{leaf.device}"
    if isinstance(leaf, (np.ndarray, np.generic)):
        return f"{leaf.dtype}{list(np.shape(leaf))}"
    return type(leaf).__name__


def tree_descriptor(tree) -> str:
    """The structure and every leaf descriptor of ``tree``: what an entry
    point's memo of runners keys on."""
    leaves, structure = flatten(tree)
    return structure + "|" + "|".join(_leaf_descriptor(x) for x in leaves)


def sharding_descriptor(tree) -> str:
    """Compact placement signature of ``tree``: the distinct meshes it holds
    (``parallel.mesh.Mesh`` / ``FleetMesh``: their shape and this rank's
    coordinates), sorted and joined; the empty string when it holds none."""
    descs: set = set()

    def walk(x) -> None:
        if isinstance(getattr(x, "shape", None), dict) and isinstance(getattr(x, "coords", None), dict):
            descs.add(f"{dict(x.shape)}@{dict(x.coords)}")
            return
        for _, child in _children(x) or ():
            walk(child)

    walk(tree)
    return ";".join(sorted(descs))


def _rank_bits() -> list:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return [f"rank{dist.get_rank()}of{dist.get_world_size()}"]
    return []


def signature_key(tag: str, statics, leaves) -> str:
    """16-hex deterministic key: tag + toolchain and source fingerprints +
    static config reprs + leaf descriptors (+ this rank of a process group
    of more than one)."""
    bits = [tag, toolchain_fp8(), source_fp8(), *_rank_bits()]
    bits += [repr(s) for s in statics]
    bits += [_leaf_descriptor(x) for x in leaves]
    return hashlib.sha256("|".join(bits).encode()).hexdigest()[:16]


def _library_entry(name: str) -> dict:
    from ringpop_tpu_torch.ops import _cuda_build

    mod = _kernel_module(name)
    into = mod.BUILD_DIR if mod.BUILD_DIR is not None else _cuda_build.build_dir()
    return {"module": name, "library": _cuda_build.library_path(mod.SOURCE, Path(into)).name}


def _load_libraries(entries: list) -> None:
    """Load the manifest's libraries, each already built for this source
    (a missing or stale one raises: the caller treats that as a miss)."""
    from ringpop_tpu_torch.ops import _cuda_build

    for entry in entries:
        want = _library_entry(entry["module"])
        if want["library"] != entry["library"]:
            raise ValueError(f"{entry['library']} is not the build of this {entry['module']} source")
        mod = _kernel_module(entry["module"])
        path = Path(mod.BUILD_DIR if mod.BUILD_DIR is not None else _cuda_build.build_dir()) / want["library"]
        if not path.exists():
            raise FileNotFoundError(f"{path} is not built")
        mod._library()


def _synchronize(leaves) -> None:
    import torch

    for dev in {x.device for x in leaves if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def load_or_compile(
    fn: Callable,
    *args,
    tag: str,
    static_kw: Optional[dict] = None,
    dyn_kw: Optional[dict] = None,
    statics: tuple = (),
    cache_dir: Optional[str] = None,
    save: bool = True,
) -> tuple:
    """The load-or-compile front door.  Returns ``(call, info)``.

    ``fn`` is called as ``fn(*args, **dyn_kw, **static_kw)``; ``args`` and
    ``dyn_kw`` are the program's inputs (their leaves' descriptors,
    ``statics`` and ``static_kw`` form the key; a Python scalar among them
    is a value, e.g. a block count), ``static_kw`` is bound into the
    program.  ``call(*args2, **dyn_kw2)`` runs it on any inputs.

    ``info``: ``cache_hit`` (a manifest existed and its libraries loaded),
    ``compile_s`` (the load on a hit; the build and warm-up run on a miss),
    ``key`` / ``path`` / ``cache_dir``, ``saved``, and ``error`` when the
    cache could not serve (the run is then uncached, on the same path)."""
    from ringpop_tpu_torch.util import accel

    if accel.cache_status()["error"] == accel.NOT_CALLED:
        accel.configure_compile_cache()
    static_kw = static_kw or {}
    dyn_kw = dyn_kw or {}
    leaves, structure = flatten((args, dyn_kw))
    info: dict = {"tag": tag, "cache_hit": False, "compile_s": None, "saved": False, "error": None}

    def plain(*a, **dk):
        return fn(*a, **dk, **static_kw)

    try:
        key = signature_key(tag, tuple(statics) + (repr(sorted(static_kw.items())),), leaves)
        cdir = cache_dir or default_cache_dir()
        path = os.path.join(cdir, f"{tag}-{key}.json")
        info.update(key=key, path=path, cache_dir=cdir)
    except Exception as e:  # noqa: BLE001 - a fingerprint that cannot be taken runs uncached
        info["error"] = f"keying failed: {type(e).__name__}: {e}"
        log.warning("aot %s: %s; running uncached", tag, info["error"])
        return plain, info

    if os.path.exists(path):
        try:
            t0 = time.perf_counter()
            with open(path) as f:
                manifest = json.load(f)
            if manifest.get("format") != MANIFEST_FORMAT or manifest.get("key") != key:
                raise ValueError(f"not a manifest of key {key}")
            _load_libraries(manifest["libraries"])
            info["compile_s"] = round(time.perf_counter() - t0, 3)
            info["cache_hit"] = True
        except Exception as e:  # noqa: BLE001 - an unusable manifest is a miss, with its reason
            info["error"] = f"load failed: {type(e).__name__}: {e}"
            log.warning("aot %s: manifest %s unusable (%s); building", tag, path, info["error"])
    if not info["cache_hit"]:
        t0 = time.perf_counter()
        before = launch_counts()
        # the warm-up: one run on copies of the inputs (a program may update
        # an input in place), which builds and loads every library it launches
        copies = _map_tensors((args, dyn_kw), lambda t: t.clone())
        out = plain(*copies[0], **copies[1])
        _synchronize(leaves)
        del out, copies
        after = launch_counts()
        launched = sorted({name.split(".")[0] for name in after if after[name] != before[name]})
        info["compile_s"] = round(time.perf_counter() - t0, 3)
        if save:
            manifest = {"format": MANIFEST_FORMAT, "tag": tag, "key": key,
                        "libraries": [_library_entry(name) for name in launched], "compile_s": info["compile_s"]}
            try:
                tmp = path + f".tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(manifest, f, sort_keys=True)
                os.replace(tmp, path)
                info["saved"] = True
            except OSError as e:
                info["error"] = f"save failed: {type(e).__name__}: {e}"
                log.warning("aot %s: %s (manifest not persisted)", tag, info["error"])

    expect = [_leaf_descriptor(x) for x in leaves]

    def call(*a, **dk):
        flat, structure2 = flatten((a, dk))
        if structure2 != structure or [_leaf_descriptor(x) for x in flat] != expect:
            # the inputs drifted from the keyed program: the same function
            # serves them, uncached (the JAX package traces afresh)
            info["error"] = info["error"] or "inputs drifted from the keyed program; ran uncached"
        return plain(*a, **dk)

    return call, info

