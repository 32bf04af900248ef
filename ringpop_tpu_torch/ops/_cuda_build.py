"""Build and load a hand-written CUDA source of ``csrc/`` as a shared library.

Each kernel source has a plain C interface.  It is compiled with ``nvcc``
for ``sm_90a`` at first use into ``ringpop_tpu_torch/_build/`` (ignored by
git), under a name keyed by a hash of the source and the flags, so an
edited source rebuilds, and loaded with ctypes by its wrapper
(``ops/hash_kernel.py``, ``ops/packbits_kernel.py``).  Nothing here runs at
import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


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


def build(source: Path, build_dir: Path, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``source``, with the macros ``defines`` (``NAME=VALUE``, for
    measurement builds), unless that library is already built.  The
    compiler's report (registers, spills) is kept beside it as
    ``<library>.log``.  Raises RuntimeError on failure."""
    path = library_path(source, build_dir, defines)
    if path.exists():
        return path
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
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
