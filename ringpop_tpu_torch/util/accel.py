"""The accelerator probe and the kernel build cache (counterpart of
``ringpop_tpu/util/accel.py``).

* :func:`probe_accelerator` asks, in a subprocess with a timeout, whether
  the CUDA card answers (its init and one small computation), and returns
  the diagnostic dict the bench records embed.  A wedged CUDA stack can hang a
  process's first CUDA call; a subprocess keeps the caller safe from it.
* :func:`ensure_live_backend` probes and raises when no card answers,
  unless the caller asked for the CPU: the port never pins a process to
  the host on its own (``device.resolve_device`` is the same rule).
* :func:`compile_cache_dir` names the directory the hand-written kernels'
  libraries are built into: a subdirectory of a base keyed by a
  fingerprint of the platform, the card (name and compute capability),
  torch, CUDA, ``nvcc --version`` and the host CPU's identity lines, so a
  library built for another card or toolchain is never loaded.
* :func:`configure_compile_cache` points ``ops/_cuda_build.py`` at that
  directory and records the outcome :func:`cache_status` returns (the run
  journal's header carries it).  Without a call, the libraries go to the
  same fingerprinted directory of :func:`default_base`: the ignored
  ``ringpop_tpu_torch/_build/``, or ``$RINGPOP_TPU_COMPILE_CACHE``.

Nothing here imports torch at module level.
"""

from __future__ import annotations

import hashlib
import logging
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

_log = logging.getLogger("ringpop_tpu_torch.accel")

NOT_CALLED = "configure_compile_cache not called"

# outcome of the LAST configure_compile_cache call in this process:
# {"cache_dir": str|None, "error": str|None}
_CACHE_STATUS: dict = {"cache_dir": None, "error": NOT_CALLED}


def cache_status() -> dict:
    """The last :func:`configure_compile_cache` outcome (a copy)."""
    return dict(_CACHE_STATUS)


def probe_accelerator(timeouts_s: Sequence[float] = (90.0, 240.0)) -> dict:
    """Probe the card's init and one small computation in a subprocess.

    Returns ``{"alive": bool, "platform": str|None, "probe_s": float,
    "reason": str}``; ``platform`` is ``"cuda"`` when the card answered.
    Escalating timeouts: a failed quick probe earns one patient retry."""
    code = (
        "import torch;"
        "assert torch.cuda.is_available(), 'no CUDA device is available';"
        "x = torch.ones((8, 8), device='cuda');"
        "float(x.sum());"
        "print('cuda')"
    )
    t0 = time.perf_counter()
    reason = "ok"
    platform: Optional[str] = None
    alive = False
    for i, timeout_s in enumerate(timeouts_s):
        try:
            r = subprocess.run([sys.executable, "-c", code], timeout=timeout_s, capture_output=True, text=True)
        except subprocess.TimeoutExpired:
            reason = f"probe timeout after {timeout_s:.0f}s (attempt {i + 1})"
            continue
        if r.returncode == 0:
            alive = True
            platform = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else None
            reason = "ok"
            break
        reason = f"probe rc={r.returncode}: {(r.stderr or '').strip()[-200:]}"
    return {"alive": alive, "platform": platform, "probe_s": round(time.perf_counter() - t0, 1), "reason": reason}


def ensure_live_backend(device=None, timeouts_s: Sequence[float] = (90.0, 240.0)) -> dict:
    """Probe the card unless the caller asked for the CPU.  Returns the
    probe dict with ``"fallback"`` None (the port never falls back); raises
    RuntimeError when a card was asked for (``device`` None or CUDA) and
    none answered.  For ``device="cpu"`` nothing is probed."""
    if device is not None and str(device).split(":")[0] == "cpu":
        return {"alive": False, "platform": "cpu", "probe_s": 0.0,
                "reason": "the caller asked for the CPU; no card was probed", "fallback": None}
    info = probe_accelerator(timeouts_s=timeouts_s)
    if not info["alive"]:
        raise RuntimeError(
            f"no CUDA device answered the probe ({info['reason']}); pass device='cpu' to run the plain "
            "PyTorch path on the host")
    info["fallback"] = None
    return info


def default_base() -> str:
    """The build cache's base: ``$RINGPOP_TPU_COMPILE_CACHE``, else the
    package's ignored ``_build/`` directory."""
    from ringpop_tpu_torch.ops import _cuda_build

    return os.environ.get("RINGPOP_TPU_COMPILE_CACHE") or str(_cuda_build.BUILD_DIR)


def _card_bits() -> list:
    import torch

    if not torch.cuda.is_available():
        return ["cpu"]
    idx = torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(idx)
    return ["cuda", torch.cuda.get_device_name(idx), f"sm_{major}{minor}"]


def _cpuinfo_bits() -> list:
    bits, seen = [], set()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                # x86 flags and identity lines; arm64 Features / CPU part.
                # Dedup by whole line: a heterogeneous host lists per-core lines.
                key = line.split(":", 1)[0].strip()
                if key in ("flags", "Features", "model name", "vendor_id", "cpu family", "model", "stepping",
                           "CPU part", "CPU implementer") and line.strip() not in seen:
                    seen.add(line.strip())
                    bits.append(line.strip())
    except OSError:  # not Linux
        pass
    return bits


_DIRS: dict = {}


def compile_cache_dir(base: str, create: bool = True) -> str:
    """The fingerprinted subdirectory of ``base`` for kernel libraries:
    ``<base>/<12 hex>``, keyed by the platform, the card's name and compute
    capability, torch, CUDA, ``nvcc --version`` and the host CPU's identity
    lines.  The fingerprint is computed once a process and base."""
    from ringpop_tpu_torch.ops import _cuda_build

    base = os.path.abspath(base)
    if base not in _DIRS:
        import torch

        bits = ["kernel-cache-v1", torch.__version__, str(torch.version.cuda), *_card_bits(),
                _cuda_build.nvcc_version(), *_cpuinfo_bits()]
        _DIRS[base] = os.path.join(base, hashlib.sha1("|".join(bits).encode()).hexdigest()[:12])
    path = _DIRS[base]
    if create:
        os.makedirs(path, exist_ok=True)
    return path


def configure_compile_cache(base: Optional[str] = None) -> Optional[str]:
    """Build and load the kernel libraries from the fingerprinted
    subdirectory of ``base`` (default :func:`default_base`).  Returns the
    directory, or None when it cannot take writes: the reason is logged and
    recorded in :func:`cache_status`, and the libraries stay where they
    were."""
    from ringpop_tpu_torch.ops import _cuda_build

    base = base or default_base()
    try:
        path = compile_cache_dir(base)
        # fail here, with a diagnosis, if the directory cannot take writes
        probe = os.path.join(path, f".writable.{os.getpid()}")
        with open(probe, "w") as f:
            f.write("probe")
        os.remove(probe)
        _cuda_build.set_build_dir(path)
        _CACHE_STATUS.update(cache_dir=path, error=None)
        return path
    except Exception as e:  # noqa: BLE001 - recorded and logged, never silent
        reason = f"{type(e).__name__}: {e}"
        _CACHE_STATUS.update(cache_dir=None, error=reason)
        _log.warning("kernel build cache not configured (base %s): %s", base, reason)
        return None
