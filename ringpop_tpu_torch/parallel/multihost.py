"""Process-group bring-up for the sim plane's ("node", "rumor") mesh.

Counterpart of ``ringpop_tpu/parallel/multihost.py``.  The JAX package
spans hosts with ``jax.distributed`` and one global device mesh; the port
runs one process a rank of the mesh over ``torch.distributed`` (rank
``p·R + r`` holds node rows block p and word block r).  Nothing
here knows of a cluster: the caller (or its launcher's environment) names
the rendezvous address, the world size and the rank.

The transport is an explicit choice (:func:`default_transport` is the
rule, applied only when the caller names none): NCCL when every rank has a
card of its own, else gloo, which stages CUDA tensors through host memory
(``parallel.mesh.Mesh`` counts those bytes).  NCCL refuses two ranks on one
card, so a single card runs its ranks over gloo.

A process-sliced fleet sweep (``sim/scenarios.FleetSweep(global_b=)``)
runs one process a block of the batch: :func:`process_count` and
:func:`process_index` name the slice and :func:`barrier` orders the
checkpoint store's writes.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch

# a desynchronised rank (one that skips a collective) fails its peers after
# this long instead of hanging them
DEFAULT_TIMEOUT_S = 60

# the default group's collective timeout, which the mesh's subgroups take too
_group_timeout_s = DEFAULT_TIMEOUT_S

# the rendezvous address init_distributed brought the default group up at:
# its TCPStore serves the fabric's key-value store too (fabric.DistributedKV)
_coordinator_address: Optional[str] = None


def _dist():
    import torch.distributed as dist

    return dist


def distributed_initialized() -> bool:
    """Is the default process group up?"""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The processes of the job: the default group's size, 1 when it is not
    up (the JAX package's ``jax.process_count``)."""
    return _dist().get_world_size() if distributed_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group, 0 when it is not up
    (``jax.process_index``)."""
    return _dist().get_rank() if distributed_initialized() else 0


def barrier() -> None:
    """Wait for every process of the job (the default group); nothing with
    one process.  The multi-process checkpoint store's barriers."""
    if process_count() > 1:
        _dist().barrier()


def group_timeout_s() -> float:
    """The collective timeout :func:`init_distributed` gave the default
    group (``DEFAULT_TIMEOUT_S`` when another caller brought it up)."""
    return _group_timeout_s


def coordinator_address() -> Optional[str]:
    """``host:port`` of the store the default group's rendezvous serves:
    the address :func:`init_distributed` was given, else torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` when the group is up, else None."""
    if _coordinator_address:
        return _coordinator_address
    env = os.environ
    if distributed_initialized() and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        return f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    return None


def default_transport(world_size: int, device=None) -> str:
    """The single-card rule: ``"nccl"`` when ``device`` is a card (or, with
    no device named, a card is visible) and there is a card for every rank,
    else ``"gloo"``."""
    on_card = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    return "nccl" if on_card and torch.cuda.device_count() >= world_size else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    transport: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Idempotently bring up the default process group.

    Arguments default from the environment: the JAX package's
    ``JAX_COORDINATOR_ADDRESS`` (``host:port``), ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``, else torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  ``transport`` is ``"nccl"`` or ``"gloo"``
    (None applies :func:`default_transport`).  Every collective of the group
    times out after ``timeout_s``.  Returns True when the group is (now)
    up, False when no address is configured (single process: build the
    mesh-free engines instead)."""
    global _group_timeout_s, _coordinator_address
    if distributed_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS")
        if not coordinator_address and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        value = env.get("JAX_NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(value) if value else None
    if process_id is None:
        value = env.get("JAX_PROCESS_ID") or env.get("RANK")
        process_id = int(value) if value else None
    if not coordinator_address:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the world size and this process's rank with an address")
    if transport is None:
        transport = default_transport(num_processes)
    if transport not in ("nccl", "gloo"):
        raise ValueError(f"unknown transport {transport!r}; 'nccl' or 'gloo'")
    _group_timeout_s = timeout_s
    _coordinator_address = coordinator_address
    _dist().init_process_group(
        backend=transport,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=timedelta(seconds=timeout_s),
    )
    return True


def make_multihost_mesh(rumor_shards: Optional[int] = None, transport: Optional[str] = None, device=None):
    """The global ("node", "rumor") mesh over every process of the job, one
    process a rank: a rumor axis of ``rumor_shards`` (default 1) and a node
    axis of the world size over it, which it must divide.  A collective
    (``mesh.make_mesh`` builds the axes' subgroups)."""
    from ringpop_tpu_torch.parallel.mesh import make_mesh

    r = 1 if rumor_shards is None else int(rumor_shards)
    size = _dist().get_world_size() if distributed_initialized() else 1
    if r < 1 or size % r:
        raise ValueError(f"rumor_shards={rumor_shards} must divide the {size} processes of the job")
    return make_mesh(shape=(size // r, r), transport=transport, device=device)
