"""The port's warm start (``ringpop_tpu_torch/util/aot.py``) and build cache
(``util/accel.py``), case for case against ``tests/test_aot.py``: the
miss → save → hit flow bit-identical to the plain call and to the JAX
package's front door, the key's sensitivity to shapes, statics, ticks and
the port's source (a ``.py`` edit and a ``csrc/*.cu`` edit), an
unwritable cache directory, a corrupt manifest and drifted inputs served
uncached on the same path with the reason in ``info["error"]``, a hit in a
fresh process, and no fallback to the plain version for a tensor that is
not on the CPU.  Also the probe and the build cache's contract.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim.delta import DeltaFaults as JFaults
from ringpop_tpu.util import aot as jaot
from ringpop_tpu_torch.ops import _cuda_build, packbits_kernel
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.sim import packbits as tp
from ringpop_tpu_torch.sim.delta import DeltaFaults
from ringpop_tpu_torch.util import accel, aot

REPO = Path(__file__).resolve().parent.parent
INFO_KEYS = {"tag", "cache_hit", "compile_s", "saved", "error", "key", "path", "cache_dir"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _up(n: int) -> np.ndarray:
    up = np.ones(n, bool)
    up[::16] = False
    return up


@pytest.fixture()
def small_block():
    params = tl.LifecycleParams(n=256, k=32, suspect_ticks=5, rng="counter")
    state = tl.init_state(params, seed=0, device="cpu")
    faults = DeltaFaults(up=torch.from_numpy(_up(params.n)))
    return params, state, faults, functools.partial(tl._run_block, params)


def assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_miss_then_hit_bit_identical_and_equal_to_jax(small_block, tmp_path):
    params, state, faults, blk = small_block
    kw = dict(tag="t-roundtrip", static_kw={"ticks": 3}, statics=(repr(params),), cache_dir=str(tmp_path))
    call, info = aot.load_or_compile(blk, state, faults, **kw)
    assert set(info) == INFO_KEYS
    assert not info["cache_hit"] and info["saved"] and info["error"] is None and info["compile_s"] >= 0
    assert os.path.exists(info["path"])
    manifest = json.loads(Path(info["path"]).read_text())
    assert manifest["key"] == info["key"] and manifest["libraries"] == []  # the CPU launches no kernel
    out = call(state, faults)
    ref = blk(state, faults, ticks=3)
    assert type(out) is type(ref)
    assert_same(ref, out)
    call2, info2 = aot.load_or_compile(blk, state, faults, **kw)
    assert info2["cache_hit"] and info2["error"] is None and not info2["saved"]
    assert_same(ref, call2(state, faults))
    # the JAX package's front door on the same block, with its record's keys
    jparams = jl.LifecycleParams(n=256, k=32, suspect_ticks=5, rng="counter")
    jblk = jax.jit(functools.partial(jl._run_block, jparams), static_argnames="ticks")
    jstate, jfaults = jl.init_state(jparams, seed=0), JFaults(up=jax.numpy.asarray(_up(256)))
    jcall, jinfo = jaot.load_or_compile(jblk, jstate, jfaults, tag="t-roundtrip", static_kw={"ticks": 3},
                                        statics=(repr(jparams),), cache_dir=str(tmp_path / "jax"))
    assert set(jinfo) == set(info)
    want = tl.state_to_numpy(out)
    for name, j in zip(jl.LifecycleState._fields, jcall(jstate, jfaults)):
        assert np.array_equal(np.asarray(j), getattr(want, name)), name


def test_key_sensitive_to_shape_statics_and_ticks(small_block, tmp_path):
    params, state, faults, blk = small_block
    kw = dict(tag="t-key", statics=(repr(params),), cache_dir=str(tmp_path), save=False)
    _, a = aot.load_or_compile(blk, state, faults, static_kw={"ticks": 2}, **kw)
    _, b = aot.load_or_compile(blk, state, faults, static_kw={"ticks": 4}, **kw)
    assert a["key"] != b["key"]  # static kwargs key the program
    p2 = tl.LifecycleParams(n=512, k=32, suspect_ticks=5, rng="counter")
    s2 = tl.init_state(p2, seed=0, device="cpu")
    f2 = DeltaFaults(up=torch.ones(512, dtype=torch.bool))
    _, c = aot.load_or_compile(functools.partial(tl._run_block, p2), s2, f2, tag="t-key", static_kw={"ticks": 2},
                               statics=(repr(p2),), cache_dir=str(tmp_path), save=False)
    assert c["key"] not in (a["key"], b["key"])  # shapes and config key it too
    p3 = tl.LifecycleParams(n=256, k=32, suspect_ticks=6, rng="counter")
    _, d = aot.load_or_compile(blk, state, faults, tag="t-key", static_kw={"ticks": 2}, statics=(repr(p3),),
                               cache_dir=str(tmp_path), save=False)
    assert d["key"] != a["key"]  # the statics


def _package_copy(tmp_path: Path) -> Path:
    dst = tmp_path / "pkg"
    shutil.copytree(REPO / "ringpop_tpu_torch", dst, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return dst


def test_key_sensitive_to_package_source(small_block, tmp_path, monkeypatch):
    """An engine edit (a ``.py`` file) or a kernel edit (a ``csrc/*.cu``
    file) must change the key: a stale manifest is never served as a hit.
    A file that is neither leaves it as it is."""
    params, state, faults, blk = small_block
    kw = dict(tag="t-src", static_kw={"ticks": 2}, statics=(repr(params),), cache_dir=str(tmp_path), save=False)
    _, a = aot.load_or_compile(blk, state, faults, **kw)
    monkeypatch.setattr(aot, "_SOURCE_FP8", "deadbeef")
    _, b = aot.load_or_compile(blk, state, faults, **kw)
    assert a["key"] != b["key"]

    pkg = _package_copy(tmp_path)
    monkeypatch.setattr(aot, "_PKG", pkg)

    def fp() -> str:
        monkeypatch.setattr(aot, "_SOURCE_FP8", None)
        return aot.source_fp8()

    base = fp()
    (pkg / "_build").mkdir()
    (pkg / "_build" / "libx.so").write_bytes(b"built")
    (pkg / "csrc" / "notes.txt").write_text("not a source")
    assert fp() == base
    cu = pkg / "csrc" / "packbits.cu"
    cu.write_text(cu.read_text() + "\n// an edit\n")
    after_cu = fp()
    assert after_cu != base
    py = pkg / "sim" / "delta.py"
    py.write_text(py.read_text() + "\n# an edit\n")
    assert fp() not in (base, after_cu)
    monkeypatch.setattr(aot, "_SOURCE_FP8", "cafef00d")
    _, c = aot.load_or_compile(blk, state, faults, **kw)
    assert c["key"] not in (a["key"], b["key"])


def test_unwritable_cache_dir_degrades_gracefully(small_block, tmp_path):
    """A save failure does not break the call: the program runs on the same
    path, and the record says why nothing persisted."""
    params, state, faults, blk = small_block
    ro = tmp_path / "ro"
    ro.write_text("not a directory")  # unwritable even for root
    call, info = aot.load_or_compile(blk, state, faults, tag="t-ro", static_kw={"ticks": 2},
                                     statics=(repr(params),), cache_dir=str(ro))
    assert not info["saved"] and not info["cache_hit"]
    assert info["error"] and "save failed" in info["error"]
    assert_same(blk(state, faults, ticks=2), call(state, faults))


def test_structure_drift_falls_back_to_plain_path(small_block, tmp_path):
    """A faults tree of another structure (None legs for tensors) runs the
    same function uncached, and the record says so."""
    params, state, faults, blk = small_block
    call, info = aot.load_or_compile(blk, state, faults, tag="t-drift", static_kw={"ticks": 2},
                                     statics=(repr(params),), cache_dir=str(tmp_path))
    assert info["error"] is None
    drifted = DeltaFaults()
    assert_same(blk(state, drifted, ticks=2), call(state, drifted))
    assert "drifted" in info["error"]


def test_corrupt_artifact_recompiles(small_block, tmp_path):
    params, state, faults, blk = small_block
    kw = dict(tag="t-corrupt", static_kw={"ticks": 2}, statics=(repr(params),), cache_dir=str(tmp_path))
    _, info = aot.load_or_compile(blk, state, faults, **kw)
    with open(info["path"], "w") as f:
        f.write("not a manifest")
    call, info2 = aot.load_or_compile(blk, state, faults, **kw)
    assert not info2["cache_hit"] and info2["error"] and "load failed" in info2["error"] and info2["saved"]
    assert_same(blk(state, faults, ticks=2), call(state, faults))
    # a manifest naming a library this source does not build is a miss too
    manifest = json.loads(Path(info["path"]).read_text())
    manifest["libraries"] = [{"module": "packbits_kernel", "library": "libpackbits_0000000000000000.so"}]
    Path(info["path"]).write_text(json.dumps(manifest))
    _, info3 = aot.load_or_compile(blk, state, faults, **kw)
    assert not info3["cache_hit"] and "is not the build of this packbits_kernel source" in info3["error"]


_FRESH = """
import hashlib, json, sys
import torch
from ringpop_tpu_torch.ops import _cuda_build
from ringpop_tpu_torch.sim import delta
from ringpop_tpu_torch.util import aot
params = delta.DeltaParams(n=512, k=64, rng="counter")
state = delta.init_state(params, seed=1, device="cpu")
import functools
run, info = aot.load_or_compile(functools.partial(delta.run_until_converged, params), state, delta.DeltaFaults(),
                                dyn_kw={"max_ticks": 8}, tag="t-fresh", static_kw={"check_every": 8},
                                statics=(repr(params),))
out, ticks, ok = run(state, delta.DeltaFaults(), max_ticks=8)
digest = hashlib.sha256(b"".join(x.numpy().tobytes() for x in out)).hexdigest()
print(json.dumps({"hit": info["cache_hit"], "error": info["error"], "digest": digest, "ticks": ticks,
                  "nvcc_runs": _cuda_build.nvcc_runs}))
"""


def test_a_hit_in_a_fresh_process_is_bit_identical_to_the_miss(tmp_path):
    env = {**os.environ, "RINGPOP_TPU_COMPILE_CACHE": str(tmp_path), "PYTHONPATH": str(REPO)}
    runs = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _FRESH], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    miss, hit = runs
    assert (miss["hit"], hit["hit"]) == (False, True) and miss["error"] is None is hit["error"]
    assert miss["digest"] == hit["digest"] and miss["ticks"] == hit["ticks"] == 8
    assert miss["nvcc_runs"] == hit["nvcc_runs"] == 0
    assert len(list(tmp_path.glob("*/aot/t-fresh-*.json"))) == 1


def test_a_tensor_off_the_cpu_never_takes_the_plain_path(tmp_path, monkeypatch):
    """A meta tensor stands in for a CUDA one: the warm-up launches the
    kernel (its device check waved through), whose build fails for want of
    nvcc, and that failure is raised, not served uncached."""
    p = torch.empty((4, 2), dtype=torch.int32, device="meta")
    monkeypatch.setattr(packbits_kernel, "_check_plane", lambda p, what: None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(packbits_kernel, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(packbits_kernel, "_lib", None)
    before = _cuda_build.nvcc_runs
    with pytest.raises(RuntimeError, match="nvcc"):
        aot.load_or_compile(tp.popcount_rows, p, tag="t-meta", cache_dir=str(tmp_path / "aot"))
    assert _cuda_build.nvcc_runs == before and not (tmp_path / "build").exists()


def test_launch_counts_name_every_kernel():
    counts = aot.launch_counts()
    assert {"hash_kernel", "packbits_kernel.row_reduce", "lifecycle_kernel.slot_walk", "threefry_kernel.randint",
            "fullview_kernel.apply", "telemetry_kernel.state_digest"} <= set(counts)


# -- the build cache and the probe ------------------------------------------------


def test_accel_cache_status_records_unwritable_base(tmp_path):
    """configure_compile_cache on an unwritable base records the reason and
    leaves the build directory where it was."""
    before = _cuda_build.build_dir()
    ro = tmp_path / "robase"
    ro.write_text("not a directory")
    try:
        assert accel.configure_compile_cache(str(ro)) is None
        status = accel.cache_status()
        assert status["cache_dir"] is None and status["error"]
        assert _cuda_build.build_dir() == before
        got = accel.configure_compile_cache(str(tmp_path / "cache"))
        assert got == str(_cuda_build.build_dir()) and accel.cache_status() == {"cache_dir": got, "error": None}
        assert Path(got).parent == tmp_path / "cache" and len(Path(got).name) == 12
        assert accel.compile_cache_dir(str(tmp_path / "cache")) == got  # the same card and toolchain
    finally:
        accel.configure_compile_cache()
        assert accel.cache_status()["error"] is None


def test_default_build_dir_is_fingerprinted_inside_the_package_build():
    assert Path(accel.compile_cache_dir(accel.default_base(), create=False)).parent == _cuda_build.BUILD_DIR


def test_accel_probe_contract():
    """The probe returns the JAX package's diagnostic dict; here, with no
    card, it reports why."""
    probe = accel.probe_accelerator(timeouts_s=(60.0,))
    assert set(probe) == {"alive", "platform", "probe_s", "reason"}
    assert isinstance(probe["alive"], bool) and probe["probe_s"] > 0
    if probe["alive"]:
        assert probe["platform"] == "cuda" and probe["reason"] == "ok"
    else:
        assert probe["reason"] != "ok" and probe["platform"] is None


def test_ensure_live_backend_raises_unless_the_cpu_is_asked_for(monkeypatch):
    """No fallback: a dead card raises unless the caller asked for the CPU."""
    monkeypatch.setattr(accel, "probe_accelerator", lambda timeouts_s: {
        "alive": False, "platform": None, "probe_s": 0.1, "reason": "probe rc=1: no CUDA device"})
    with pytest.raises(RuntimeError, match="no CUDA device answered"):
        accel.ensure_live_backend()
    with pytest.raises(RuntimeError, match="no CUDA device answered"):
        accel.ensure_live_backend("cuda:0")
    assert accel.ensure_live_backend("cpu")["fallback"] is None
    monkeypatch.setattr(accel, "probe_accelerator", lambda timeouts_s: {
        "alive": True, "platform": "cuda", "probe_s": 0.1, "reason": "ok"})
    assert accel.ensure_live_backend()["fallback"] is None
