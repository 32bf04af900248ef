"""The Fingerprint32 kernel for Hopper: build, bind and launch.

Replaces ``ringpop_tpu/ops/hash_pallas.py`` (``fingerprint32_pallas`` and its
``_mix_kernel``).  The kernel, ``csrc/fingerprint32.cu``, is CUDA C++ for
``sm_90a`` with a plain C entry point: it is compiled with ``nvcc`` at first
use into ``ringpop_tpu_torch/_build/`` (keyed by a hash of the source and the
flags, so an edited source rebuilds) and loaded with ctypes.  Nothing is
built or loaded when this module is imported.

:func:`fingerprint32` follows its input's device: a CPU tensor takes the plain
PyTorch version (``hash_ops.fingerprint32_device``), a CUDA tensor takes the
kernel — or raises.  There is no fallback from the kernel to the plain
version and no per-width verdict cache: the JAX package guards its kernel
because Mosaic may refuse to lower it, and ``nvcc`` either builds this one
or the build fails loudly.

``launches`` counts kernel launches (one per :func:`fingerprint32_cuda`
call that reaches the card), so a run can show its main path went through
the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ringpop_tpu_torch.ops.hash_ops import check_key_matrix, fingerprint32_device

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fingerprint32.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = 0

_lib = None
_lib_lock = threading.Lock()


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the Fingerprint32 kernel "
        "cannot be built on this machine"
    )


def _library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfingerprint32_{key[:16]}.so"


def build() -> Path:
    """Compile ``csrc/fingerprint32.cu`` unless the library for this source
    is already built.  The compiler's report (registers, spills) is kept
    beside it as ``<library>.log``.  Raises RuntimeError on failure."""
    path = _library_path()
    if path.exists():
        return path
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rp_fingerprint32.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.rp_fingerprint32.restype = ctypes.c_int
            _lib = lib
        return _lib


def fingerprint32_cuda(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: uint8[B, W] CUDA key matrix + lengths -> int64[B]
    holding each uint32 Fingerprint32.  Raises ValueError for a tensor that
    is not on the card and RuntimeError when the kernel cannot be built or
    its launch is refused."""
    global launches
    check_key_matrix(mat, lens)
    if not mat.is_cuda:
        raise ValueError(f"fingerprint32_cuda needs CUDA tensors, got {mat.device}")
    if not mat.is_contiguous():
        raise ValueError("key matrix must be contiguous")
    lens = lens.to(torch.int32).contiguous()
    rows, width = mat.shape
    # the kernel writes uint32 bit patterns; int32 is their storage type here
    out = torch.empty(rows, dtype=torch.int32, device=mat.device)
    lib = _library()
    if rows:
        with torch.cuda.device(mat.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.rp_fingerprint32(
                mat.data_ptr(), lens.data_ptr(), out.data_ptr(), rows, width, stream
            )
        if err != 0:
            raise RuntimeError(f"fingerprint32 kernel launch failed: cudaError {err}")
        launches += 1
    # widen once: a hash >= 2**31 must never reach a comparison as int32
    return out.to(torch.int64) & 0xFFFFFFFF


def fingerprint32(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Fingerprint32 of each key row, int64[B] on the input's device: the
    plain PyTorch version for CPU tensors, the kernel for CUDA tensors."""
    if mat.device.type == "cpu":
        return fingerprint32_device(mat, lens)
    return fingerprint32_cuda(mat, lens)
