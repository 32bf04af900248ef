"""Build and load a hand-written CUDA source of ``csrc/`` as a shared library.

Each kernel source has a plain C interface.  It is compiled with ``nvcc``
for ``sm_90a`` at first use into the build directory, under a name keyed by
a hash of the source and the flags, so an edited source rebuilds, and
loaded with ctypes by its wrapper (``ops/hash_kernel.py``,
``ops/packbits_kernel.py``, …).  The build directory is the one
``util/accel.configure_compile_cache`` set, else the fingerprinted
subdirectory of the ignored ``ringpop_tpu_torch/_build/`` (or of
``$RINGPOP_TPU_COMPILE_CACHE``) for this card and toolchain
(``util/accel.compile_cache_dir``).  ``nvcc_runs`` counts the compiler's
runs in this process.  Nothing here runs at import time.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

nvcc_runs = 0  # nvcc processes this process started
_build_dir: Optional[Path] = None


def set_build_dir(path) -> None:
    """Build and load the libraries from ``path`` from now on
    (``util/accel.configure_compile_cache``)."""
    global _build_dir
    _build_dir = Path(path)


def build_dir() -> Path:
    """Where the libraries are built: the configured directory, else the
    fingerprinted subdirectory of ``util/accel.default_base()``."""
    global _build_dir
    if _build_dir is None:
        from ringpop_tpu_torch.util import accel

        _build_dir = Path(accel.compile_cache_dir(accel.default_base(), create=False))
    return _build_dir


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """``nvcc --version``'s report, or ``"no-nvcc"`` where there is none
    (asked once a process)."""
    try:
        proc = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return "no-nvcc"
    return proc.stdout.strip() if proc.returncode == 0 else "no-nvcc"


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be "
        "built on this machine"
    )


def library_path(source: Path, build_dir: Path, defines: tuple[str, ...] = ()) -> Path:
    """Where the library built from ``source`` with ``NVCC_FLAGS`` and the
    macros ``defines`` (``NAME=VALUE``) lives."""
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    key = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()
    return build_dir / f"lib{source.stem}_{key[:16]}.so"


def build(source: Path, into: Optional[Path] = None, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``source``, with the macros ``defines`` (``NAME=VALUE``, for
    measurement builds), into ``into`` (default :func:`build_dir`) unless
    that library is already built.  The compiler's report (registers,
    spills) is kept beside it as ``<library>.log``.  Raises RuntimeError on
    failure."""
    global nvcc_runs
    into = build_dir() if into is None else Path(into)
    path = library_path(source, into, defines)
    if path.exists():
        return path
    nvcc = find_nvcc()
    into.mkdir(parents=True, exist_ok=True)
    nvcc_runs += 1
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path
