"""simbench — the BASELINE.json scenario suite on the port (counterpart of
``ringpop_tpu/cli/simbench.py``: the same rows, flags and record keys).

Prints one JSON line a scenario (``bench``, ``platform``, ``full_scale``
and ``wall_s`` set as the JAX package's ``main`` sets them):

1. ``host10``      — 10 ``Node``s over TCP: bootstrap, converge, one silent
                     death seen faulty.
2. ``loss1k``      — 1k-node lifecycle sim, 5 % loss, 1 % crashed: ticks
                     until every live node holds every victim faulty.
3. ``sweep100k``   — 100k-node lifecycle sim: the suspicion-timeout sweep.
4. ``partition1m`` — 1M-node delta sim: 30 % partition, heal, converge.
5. ``ring1m``      — 1M-vnode ring: batched lookups, keyed lookups through
                     the Fingerprint32 kernel, a 1 % churn rebuild.

and every other row of the JAX suite: ``montecarlo``, ``mc_churn``,
``mc_chaos``, ``fleet_scale``, ``partition_lc``, ``sharded100k``,
``delta16m``, ``multihost16m``, ``dcn_wire``, ``swing_overlap``, the chaos
rows ``churn100k``, ``flap1k``, ``asym_partition``, ``topo_chaos``, the
host-plane rows ``forward``, ``forward_comparator``, ``forward_ab``, the
serve rows ``serve_ring``, ``serve_fanin`` and ``gameday``.

Where the JAX package runs a certificate in a child with 8 virtual CPU
devices (``sharded100k``, the chaos rows' sharded twin, the fleet twin),
the port runs it on a mesh of 8 rank processes (``parallel.mesh``; gloo
on one card or on the host, NCCL when every rank has a card).  The
multi-process rows start their ranks through ``cli.multihost_launch``.

Device rule: the rows run on the card; ``--cpu`` runs them on the host
(the plain PyTorch path) at the non-full sizes unless ``--full``.  Without
``--cpu`` and with no card, the CLI exits nonzero and runs no row.
Usage::

    python -m ringpop_tpu_torch.cli.simbench [--only NAME] [--full] [--cpu] [--seed N]
"""

from __future__ import annotations

import argparse
import functools as _functools
import hashlib
import json
import sys
import time
from typing import Optional

import numpy as np
import torch


def _emit(result: dict) -> None:
    print(json.dumps(result), flush=True)


# --telemetry PATH: the run-journal sink (sim/telemetry.py).  Each
# engine-driving row opens the shared JSONL in append mode and writes its
# own header record, so one file carries the whole run.  None (the
# default) leaves every measured path as it is.
_TELEMETRY_PATH = None

# the device every row runs on when its caller names none: None is the
# card (``device.resolve_device`` raises without one); ``main`` sets it
_DEVICE = None

# the final engine states and outputs of the last run of each row, keyed
# by row, for a caller that checks them (the chip smoke digests them);
# they are not part of the record
LAST_RUN: dict = {}

RANK_GROUP_DEADLINE_S = 1800


def _device(device=None) -> torch.device:
    from ringpop_tpu_torch.device import resolve_device

    return resolve_device(_DEVICE if device is None else device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_device(dev: torch.device) -> Optional[str]:
    """The launcher's device argument: None puts rank r on the card
    ``cuda:{r % cards}``; the host is named."""
    return None if dev.type == "cuda" else str(dev)


def _telemetry_sink(scenario: str, engine: str, params: dict):
    """A TelemetrySink journaling to the --telemetry file, or None."""
    if _TELEMETRY_PATH is None:
        return None
    from ringpop_tpu_torch.sim.telemetry import TelemetryJournal, TelemetrySink

    journal = TelemetryJournal(_TELEMETRY_PATH, append=True)
    journal.header(engine, scenario, params)
    return TelemetrySink(journal=journal)


def _close_sink(sink) -> None:
    if sink is not None and sink.journal is not None:
        sink.journal.close()


def _platform() -> str:
    """``"gpu"`` when the card answers the probe (``util/accel``, in a
    subprocess); raises RuntimeError when none does."""
    from ringpop_tpu_torch.util.accel import ensure_live_backend

    ensure_live_backend()
    return "gpu"


def _leaf_sha(tree) -> list:
    """sha256 of each leaf of a state (the port's dtypes), as host bytes."""
    out = []
    for leaf in tree:
        a = np.ascontiguousarray(leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf)
        out.append(hashlib.sha256(str((a.dtype, a.shape)).encode() + a.tobytes()).hexdigest())
    return out


# -- rank groups: the port's counterpart of the 8-virtual-device children -----


def _rank_group(shape: tuple, jobs: list, device: torch.device) -> list:
    """Run ``jobs`` (a list of (name, job, payload)) on one mesh of spawned
    rank processes of ``shape`` ((P, R), or (Bm, P, R) for a fleet mesh),
    one process a rank, on ``device``'s kind; returns every rank's {name:
    result}.
    Raises RuntimeError with the traceback of a rank that failed, or when
    the group misses its deadline; every process is stopped either way."""
    import queue
    import socket

    import torch.multiprocessing as mp

    size = int(np.prod(shape))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(rank, size, port, tuple(shape), jobs, results, device.type),
                         daemon=True) for rank in range(size)]
    for proc in procs:
        proc.start()
    got = {}
    deadline = time.perf_counter() + RANK_GROUP_DEADLINE_S
    try:
        while len(got) < size:
            try:
                rank, ok, out = results.get(timeout=max(1.0, deadline - time.perf_counter()))
            except queue.Empty:
                raise RuntimeError(f"a group of {size} ranks missed its {RANK_GROUP_DEADLINE_S} s deadline") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {size} failed:\n{out}")
            got[rank] = out
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [got[r] for r in range(size)]


def _rank_main(rank: int, size: int, port: int, shape: tuple, jobs: list, results, kind: str) -> None:
    import traceback

    import torch.distributed as dist

    try:
        from ringpop_tpu_torch.parallel import mesh as pmesh, multihost

        if kind == "cuda":
            dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}")
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(1)
        transport = multihost.default_transport(size, dev)
        multihost.init_distributed(f"127.0.0.1:{port}", size, rank, transport=transport)
        if len(shape) == 3:
            mesh = pmesh.make_fleet_mesh(shape=shape, transport=transport, device=dev)
        else:
            mesh = pmesh.make_mesh(shape=shape, transport=transport, device=dev)
        out = {name: _RANK_JOBS[job](mesh, payload) for name, job, payload in jobs}
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))  # the parent raises it
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def bench_host10(seed: int, full: bool, device=None) -> dict:
    """10 real nodes over TCP: bootstrap → converged checksums → kill one →
    survivors converge on faulty.  Torch-free, like the host stack."""
    import asyncio

    from ringpop_tpu_torch.net import TCPChannel
    from ringpop_tpu_torch.swim.node import BootstrapOptions, Node, NodeOptions
    from ringpop_tpu_torch.swim.state_transitions import StateTimeouts

    n = 10

    async def run():
        chans = [TCPChannel(app="simbench") for _ in range(n)]
        for ch in chans:
            await ch.listen()
        nodes = [
            Node(
                "simbench",
                ch.hostport,
                ch,
                NodeOptions(
                    min_protocol_period=0.02,
                    ping_timeout=0.2,
                    ping_request_timeout=0.4,
                    state_timeouts=StateTimeouts(suspect=0.8),
                ),
            )
            for ch in chans
        ]
        hosts = [nd.address for nd in nodes]
        t0 = time.perf_counter()
        await asyncio.gather(
            *(nd.bootstrap(BootstrapOptions(discover_provider=hosts, join_timeout=1.0)) for nd in nodes)
        )
        deadline = time.perf_counter() + 30
        while time.perf_counter() < deadline:
            if len({nd.memberlist.checksum() for nd in nodes}) == 1:
                break
            await asyncio.sleep(0.05)
        t_converge = time.perf_counter() - t0
        converged = len({nd.memberlist.checksum() for nd in nodes}) == 1

        t1 = time.perf_counter()
        victim = nodes[-1]
        victim.destroy()  # silent death: timers torn down, no Leave announced
        await chans[-1].close()
        detected = False
        deadline = time.perf_counter() + 30
        while time.perf_counter() < deadline:
            ok = all(
                any(m.address == victim.address and m.status >= 2 for m in nd.memberlist.get_members())
                for nd in nodes[:-1]
            )
            if ok:
                detected = True
                break
            await asyncio.sleep(0.05)
        t_detect = time.perf_counter() - t1

        for nd in nodes[:-1]:
            nd.destroy()
        # each close joins its link threads: close them together
        await asyncio.gather(*(ch.close() for ch in chans[:-1]))
        return t_converge, converged, t_detect, detected

    t_converge, converged, t_detect, detected = asyncio.run(run())
    return {
        "metric": "host_cluster_10node",
        "value": round(t_converge, 3),
        "unit": "s_to_converge",
        "converged": converged,
        "failure_detect_s": round(t_detect, 3),
        "detected": detected,
    }


def bench_loss1k(seed: int, full: bool, device=None) -> dict:
    from ringpop_tpu_torch.sim.delta import DeltaFaults
    from ringpop_tpu_torch.sim.lifecycle import LifecycleSim

    dev = _device(device)
    n = 1000
    sink = _telemetry_sink("loss1k", "lifecycle", {"n": n, "k": 128, "seed": seed})
    sim = LifecycleSim(n=n, k=128, seed=seed, suspect_ticks=25, rng="counter", telemetry=sink, device=dev)
    rng = np.random.default_rng(seed)
    victims = sorted(rng.choice(n, size=10, replace=False).tolist())
    up = np.ones(n, bool)
    up[victims] = False
    faults = DeltaFaults(up=torch.from_numpy(up).to(dev), drop_rate=0.05)

    try:
        sim.tick(faults)  # the first tick: builds and loads the kernels on the card
        _sync(dev)
        t0 = time.perf_counter()
        ticks, ok = sim.run_until_detected(victims, faults, max_ticks=4000)
        elapsed = time.perf_counter() - t0
        # continue to full quiescence (the reference's waitForConvergence
        # criterion) — only meaningful when detection actually completed
        conv_ticks, conv_ok = sim.run_until_converged(faults, max_ticks=4000) if ok else (None, False)
    finally:
        _close_sink(sink)  # a dying bench must still flush its journal tail
    LAST_RUN["loss1k"] = {"states": [sim.state]}
    return {
        "metric": "lifecycle_1k_5pct_loss_detection",
        "value": round(elapsed, 3),
        "unit": "s",
        "ticks": ticks,
        "sim_seconds": round(ticks * sim.params.tick_ms / 1000, 1),
        "detected": ok,
        "n_victims": len(victims),
        "quiescence_ticks_after_detect": conv_ticks,
        "quiesced": conv_ok,
    }


def bench_montecarlo(seed: int, full: bool, device=None) -> dict:
    """Detection-latency distribution over B seeded replicas
    (``sim/montecarlo.py``)."""
    from ringpop_tpu_torch.sim.montecarlo import detection_latency_distribution

    dev = _device(device)
    n = 4096 if full else 512
    b = 32 if full else 8
    rng = np.random.default_rng(seed)
    victims = sorted(rng.choice(n, size=4, replace=False).tolist())
    out = detection_latency_distribution(
        n=n, seeds=range(seed, seed + b), victims=victims, k=32, max_ticks=1024, device=dev
    )
    return {
        "metric": f"mc_detection_distribution_n{n}_x{b}",
        # -1 sentinel keeps the value numeric when no replica detected
        "value": -1.0 if out["ticks_median"] is None else out["ticks_median"],
        "unit": "ticks_median",
        "ticks_p90": out["ticks_p90"],
        "ticks_max": out["ticks_max"],
        "sim_s_median": out["sim_s_median"],
        "replicas": out["n_replicas"],
        "all_detected": out["detected"] == out["n_replicas"],
        "ticks_all": out["ticks_all"],
    }


def _delta_init_packed(params, seed: int, device) -> "object":
    """``delta.init_state(params, seed)`` built word by word: the sources'
    bits OR-ed on the host into their (row, word) cells and ``ride_ok``'s
    constant words, with no [N, K] bool plane (1 GB at 16M x 64, more in
    ``pack_bool``'s byte intermediates).  Leaf for leaf equal to
    ``init_state`` (tested)."""
    from ringpop_tpu_torch.sim import prng
    from ringpop_tpu_torch.sim.delta import DeltaState, clamped_max_p
    from ringpop_tpu_torch.sim.packbits import WORD, n_words

    n, k = params.n, params.k
    w = n_words(k)
    src = np.arange(k, dtype=np.int64) % n
    cells: dict = {}
    for j, row in enumerate(src.tolist()):
        cell = (row, j // WORD)
        cells[cell] = cells.get(cell, 0) | (1 << (j % WORD))
    learned = torch.zeros((n, w), dtype=torch.int32, device=device)
    if cells:
        rows = torch.tensor([c[0] for c in cells], dtype=torch.int64, device=device)
        cols = torch.tensor([c[1] for c in cells], dtype=torch.int64, device=device)
        vals = np.array(list(cells.values()), dtype=np.uint32).view(np.int32)
        learned[rows, cols] = torch.from_numpy(vals).to(device)
    # ride_ok: every slot's (zero) counter is below the cap, so each word
    # holds the bits of its slots that exist
    below_cap = clamped_max_p(params) > 0
    words = [(1 << (min(WORD, k - i * WORD) if below_cap else 0)) - 1 for i in range(w)]
    ride = torch.from_numpy(np.array(words, dtype=np.uint32).view(np.int32)).to(device)
    return DeltaState(
        learned=learned,
        pcount=torch.zeros((n, k), dtype=torch.int8, device=device),
        ride_ok=ride.expand(n, w).contiguous(),
        tick=torch.zeros((), dtype=torch.int32, device=device),
        key=prng.prng_key(seed, device),
    )


def bench_delta16m(seed: int, full: bool, device=None) -> dict:
    """Stretch scale: rumor convergence at 16 million nodes.  The packed
    planes (uint32 words + int8 counters at [N, 64]) hold this in ~1.3 GB;
    the state is built word by word (:func:`_delta_init_packed`)."""
    from ringpop_tpu_torch.sim.delta import DeltaParams, run_until_converged

    dev = _device(device)
    n = 16_000_000 if full else 2_000_000
    params = DeltaParams(n=n, k=64, rng="counter")
    state = _delta_init_packed(params, seed, dev)
    run_until_converged(params, state, max_ticks=8)  # builds and loads the kernels on the card, warms
    del state
    state = _delta_init_packed(params, seed + 1, dev)
    _sync(dev)
    t0 = time.perf_counter()
    dstate, ticks, ok = run_until_converged(params, state, max_ticks=4096)
    _sync(dev)
    wall = time.perf_counter() - t0
    LAST_RUN["delta16m"] = {"states": [dstate], "params": params}
    return {
        "metric": f"delta_{n // 1_000_000}m_convergence",
        "value": round(wall, 2),
        "unit": "s",
        "n_nodes": n,
        "n_rumors": 64,
        "ticks": ticks,
        "converged": ok,
    }


# -- sharded100k: 6 ticks, the detect path and the 1M step on a 4 x 2 mesh -----

# the JAX rows' children reshape 8 virtual devices to (node 4, rumor 2): the port's
# certificates run on 8 rank processes of that shape
MESH_SHAPE = (4, 2)


def _sh100k_config(n: int, k: int, seed: int, device):
    from ringpop_tpu_torch.sim import lifecycle
    from ringpop_tpu_torch.sim.delta import DeltaFaults

    rng = np.random.default_rng(seed)
    victims = np.sort(rng.choice(n, size=100, replace=False))
    up = np.ones(n, bool)
    up[victims] = False
    params = lifecycle.LifecycleParams(n=n, k=k, suspect_ticks=10, rng="counter")
    return params, victims, DeltaFaults(up=torch.from_numpy(up).to(device))


DETECT_KW = {"block_ticks": 32, "max_blocks": 16}


def _sh100k_unsharded(n: int, k: int, ticks: int, seed: int, device) -> dict:
    """The unsharded side of sharded100k: ``ticks`` ticks and the detect
    path twice (the second call's wall is execute-only, as the JAX row's
    ``exec_s``), with every leaf's sha256 and the states' digests."""
    from ringpop_tpu_torch.sim import lifecycle
    from ringpop_tpu_torch.sim.telemetry import tree_digest
    from ringpop_tpu_torch.swim.member import FAULTY

    params, victims, faults = _sh100k_config(n, k, seed, device)
    t0 = time.perf_counter()
    ref = lifecycle._run_block(params, lifecycle.init_state(params, seed=seed, device=device), faults, ticks)
    _sync(device)
    out = {"tick_s": time.perf_counter() - t0, "tick_sha": _leaf_sha(ref), "tick_digest": int(tree_digest(ref))}
    subjects = torch.as_tensor(victims, device=device)
    for key in ("detect", "detect_exec"):
        t0 = time.perf_counter()
        dref, blocks, done = lifecycle._run_until_detected_device(
            params, lifecycle.init_state(params, seed=seed, device=device), faults, subjects,
            min_status=FAULTY, **DETECT_KW)
        _sync(device)
        out[f"{key}_s"] = time.perf_counter() - t0
    out.update(blocks=int(blocks), done=bool(done), detect_sha=_leaf_sha(dref), detect_digest=int(tree_digest(dref)))
    return out


def _sharded100k_rank(mesh, payload: dict) -> dict:
    """One rank of sharded100k: the ``ticks`` ticks and the detect path
    (twice, the node-sharded walk hint) over the mesh, each gathered and
    digested on the lead rank; then, when asked, :func:`step1m_rank`."""
    from ringpop_tpu_torch.parallel import partition
    from ringpop_tpu_torch.parallel.mesh import with_exchange_mesh
    from ringpop_tpu_torch.sim import lifecycle
    from ringpop_tpu_torch.swim.member import FAULTY

    n, k, ticks, seed = payload["n"], payload["k"], payload["ticks"], payload["seed"]
    dev = mesh.device
    lead = mesh.coords == {"node": 0, "rumor": 0}
    params, victims, faults = _sh100k_config(n, k, seed, dev)
    sp = with_exchange_mesh(params, mesh)
    t0 = time.perf_counter()
    sout = lifecycle._run_block(sp, lifecycle.init_state(sp, seed=seed), faults, ticks)
    _sync(dev)
    out = {"sharded_s": time.perf_counter() - t0, "transport": mesh.transport}
    leaves = partition.host_gather(sout, mesh)
    out["tick_sha"] = _leaf_sha(leaves) if lead else None
    hint = partition.NamedSharding(mesh, partition.P("node", None))
    subjects = torch.as_tensor(victims, device=dev)
    for key in ("detect", "detect_exec"):
        t0 = time.perf_counter()
        dsh, blocks, done = lifecycle._run_until_detected_device(
            sp, lifecycle.init_state(sp, seed=seed), faults, subjects, min_status=FAULTY,
            learned_sharding=hint, **DETECT_KW)
        _sync(dev)
        out[f"{key}_s"] = time.perf_counter() - t0
    leaves = partition.host_gather(dsh, mesh)
    out.update(blocks=int(blocks), done=bool(done), detect_sha=_leaf_sha(leaves) if lead else None)
    if payload.get("step1m"):
        out["step1m"] = step1m_rank(mesh, seed, **payload["step1m"])
    return out


STEP1M = {"n": 1_000_000, "k": 256, "suspect_ticks": 10}


def step1m_rank(mesh, seed: int, n: int = STEP1M["n"], k: int = STEP1M["k"]) -> dict:
    """sharded100k's ``step1m`` leg on this rank: one 1M x 256 step over
    the mesh through the warm-start front door (``util/aot``, tag
    ``step1m``), its first call and a second one timed; every rank calls it
    in step.  A failure is reported in the record, as the JAX row does."""
    import dataclasses

    from ringpop_tpu_torch.parallel.mesh import with_exchange_mesh
    from ringpop_tpu_torch.sim import lifecycle
    from ringpop_tpu_torch.sim.delta import DeltaFaults
    from ringpop_tpu_torch.util import aot

    dev = mesh.device
    try:
        p1m = lifecycle.LifecycleParams(n=n, k=k, suspect_ticks=STEP1M["suspect_ticks"], rng="counter")
        sp = with_exchange_mesh(p1m, mesh)
        up1 = np.ones(n, bool)
        up1[::1000] = False
        f1m = DeltaFaults(up=torch.from_numpy(up1).to(dev))
        s1m = lifecycle.init_state(sp, seed=seed)
        # the key's statics: the params without the mesh object, and the
        # mesh's shape (the front door adds this rank and the group's size)
        statics = (repr(dataclasses.replace(sp, exchange_mesh=None)), repr(sorted(mesh.shape.items())))
        call1m, aot_info = aot.load_or_compile(
            _functools.partial(lifecycle._run_block, sp), s1m, f1m, tag="step1m", static_kw={"ticks": 1},
            statics=statics)
        t0 = time.perf_counter()
        o1m = call1m(s1m, f1m)
        _sync(dev)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        o1m2 = call1m(s1m, f1m)
        _sync(dev)
        execute_s = time.perf_counter() - t0
        del o1m2
        LAST_RUN["step1m"] = {"states": [o1m]}
        return dict(ok=True, first_call_s=round(first_s, 2), compile_s=aot_info["compile_s"],
                    execute_s=round(execute_s, 2), cache_hit=aot_info["cache_hit"], aot_error=aot_info["error"],
                    cache_dir=aot_info.get("cache_dir"), tick=int(o1m.tick))
    except Exception as e:  # noqa: BLE001 - reported, not fatal (the JAX row's discipline)
        return dict(ok=False, error=(type(e).__name__ + ": " + str(e))[:300])


def sharded_certificate(n: int, k: int, ticks: int, seed: int, device, step1m: Optional[dict] = None) -> dict:
    """The certificate sharded100k's record is made of: the unsharded run
    here, the sharded one on a 4 x 2 mesh of rank processes, compared leaf
    by leaf (sha256 of every gathered leaf); with ``step1m`` (``{"n",
    "k"}``), then :func:`step1m_rank` at that size on the same mesh.  The
    unsharded states' digests ride along (``digests``)."""
    ref = _sh100k_unsharded(n, k, ticks, seed, device)
    ranks = _rank_group(MESH_SHAPE, [("sh", "sharded100k", {"n": n, "k": k, "ticks": ticks, "seed": seed,
                                                            "step1m": step1m})], device)
    lead = ranks[0]["sh"]
    detect = dict(detected=ref["done"], ticks=ref["blocks"] * DETECT_KW["block_ticks"],
                  blocks_equal=ref["blocks"] == lead["blocks"], verdict_equal=ref["done"] == lead["done"],
                  state_equal=ref["detect_sha"] == lead["detect_sha"],
                  unsharded_s=round(ref["detect_s"], 2), sharded_s=round(lead["detect_s"], 2),
                  unsharded_exec_s=round(ref["detect_exec_s"], 2), sharded_exec_s=round(lead["detect_exec_s"], 2))
    return dict(tick_equal=ref["tick_sha"] == lead["tick_sha"], n_devices=len(ranks),
                unsharded_s=round(ref["tick_s"], 2), sharded_s=round(lead["sharded_s"], 2), ticks=ticks,
                detect=detect, transport=lead["transport"],
                step1m=lead.get("step1m", dict(ok=False, error="not attempted")),
                digests={"tick": ref["tick_digest"], "detect": ref["detect_digest"]})


def bench_sharded100k(seed: int, full: bool, device=None) -> dict:
    """The sharded lifecycle step at scale over a (node x rumor) mesh of 8
    rank processes: every gathered leaf equal to the unsharded step's, the
    full detect path likewise, and one 1M x 256 step on the same mesh
    through the warm start."""
    del full  # scale IS the point of this scenario — always 100k
    dev = _device(device)
    n = 100_000
    ticks = 6
    try:
        child = sharded_certificate(n, 256, ticks, seed, dev, step1m={"n": STEP1M["n"], "k": STEP1M["k"]})
    except RuntimeError as e:
        return {
            "metric": f"sharded_lifecycle_step_n{n}",
            "value": None,
            "unit": "s",
            "sharded": True,
            "error": str(e)[-400:],
        }
    detect = child["detect"]
    detect_equal = detect["blocks_equal"] and detect["verdict_equal"] and detect["state_equal"]
    result = {
        "metric": f"sharded_lifecycle_step_n{n}",
        "value": child["sharded_s"],
        "unit": "s",
        "sharded": True,
        "n_nodes": n,
        "n_rumor_slots": 256,
        "mesh": f"4x2 (node x rumor), {child['n_devices']} rank processes over {child['transport']}",
        "ticks": child["ticks"],
        "tick_equal_to_unsharded": child["tick_equal"],
        "unsharded_s": child["unsharded_s"],
        "detect_path": True,
        "detect_detected": detect["detected"],
        "detect_ticks": detect["ticks"],
        "detect_equal": detect_equal,
        "detect_sharded_s": detect["sharded_s"],
        "detect_unsharded_s": detect["unsharded_s"],
        "detect_sharded_exec_s": detect.get("sharded_exec_s"),
        "detect_unsharded_exec_s": detect.get("unsharded_exec_s"),
        "step1m": child["step1m"],
        "equal": child["tick_equal"] and detect_equal,
    }
    if not result["equal"]:
        # the certificate IS the scenario — a mismatch must read as failure
        result["ok"] = False
        result["error"] = "sharded run diverged from unsharded run"
    return result


# -- shared forwarding-bench plumbing (forward, forward_comparator, forward_ab)


class _MinimalProxy:
    """The comparator fixture: a minimal asyncio TCP proxy — 4-byte-length
    JSON frames, client → proxy → echo upstream → back, zero protocol
    logic (the bare asyncio + socket + json ceiling of the host)."""

    def __init__(self):
        self.conns = []
        self._servers = []

    async def start(self, wave: int):
        import asyncio
        import json as _json
        import struct

        async def _serve_echo(reader, writer):
            try:
                while True:
                    (ln,) = struct.unpack(">I", await reader.readexactly(4))
                    body = _json.loads(await reader.readexactly(ln))
                    out = _json.dumps({"ok": True, "i": body["i"]}).encode()
                    writer.write(struct.pack(">I", len(out)) + out)
                    await writer.drain()
            except (asyncio.IncompleteReadError, ConnectionResetError):
                pass

        echo_srv = await asyncio.start_server(_serve_echo, "127.0.0.1", 0)
        echo_port = echo_srv.sockets[0].getsockname()[1]

        async def _serve_proxy(reader, writer):
            up_r, up_w = await asyncio.open_connection("127.0.0.1", echo_port)
            try:
                while True:
                    hdr = await reader.readexactly(4)
                    payload = await reader.readexactly(struct.unpack(">I", hdr)[0])
                    up_w.write(hdr + payload)
                    await up_w.drain()
                    rhdr = await up_r.readexactly(4)
                    rbody = await up_r.readexactly(struct.unpack(">I", rhdr)[0])
                    writer.write(rhdr + rbody)
                    await writer.drain()
            except (asyncio.IncompleteReadError, ConnectionResetError):
                pass
            finally:
                up_w.close()

        proxy_srv = await asyncio.start_server(_serve_proxy, "127.0.0.1", 0)
        proxy_port = proxy_srv.sockets[0].getsockname()[1]
        self._servers = [proxy_srv, echo_srv]
        self.conns = [await asyncio.open_connection("127.0.0.1", proxy_port) for _ in range(wave)]
        return self

    async def _drive(self, conn, base, count):
        import json as _json
        import struct

        reader, writer = conn
        for i in range(count):
            out = _json.dumps({"i": base + i}).encode()
            writer.write(struct.pack(">I", len(out)) + out)
            await writer.drain()
            (ln,) = struct.unpack(">I", await reader.readexactly(4))
            await reader.readexactly(ln)

    async def rep(self, rep_idx: int, per_conn: int) -> float:
        """One timed rep: every connection drives per_conn requests
        concurrently; returns req/s."""
        import asyncio

        t0 = time.perf_counter()
        await asyncio.gather(
            *(self._drive(c, (rep_idx * len(self.conns) + j) * per_conn, per_conn) for j, c in enumerate(self.conns))
        )
        return len(self.conns) * per_conn / (time.perf_counter() - t0)

    def close(self):
        for _, w in self.conns:
            w.close()
        for srv in self._servers:
            srv.close()


class _FwdCluster:
    """The full-path fixture: a live 3-node TCP ringpop cluster with a
    keyed /op handler; requests enter at node 0 via handle_or_forward, so
    ~2/3 proxy to the key's owner over the wire and ~1/3 handle locally."""

    def __init__(self):
        self.rps = []
        self.chans = []

    async def start(self):
        import asyncio

        from ringpop_tpu_torch.net import TCPChannel
        from ringpop_tpu_torch.ringpop import Ringpop

        self.chans = [TCPChannel(app="fwd") for _ in range(3)]
        for ch in self.chans:
            await ch.listen()
            ch.register("fwd", "/op", lambda body, headers: {"ok": True})
        self.rps = [Ringpop("fwd", ch) for ch in self.chans]
        hosts = [ch.hostport for ch in self.chans]
        await asyncio.gather(*(rp.bootstrap(discover_provider=hosts) for rp in self.rps))
        return self

    async def one(self, i: int) -> bool:
        handled, _ = await self.rps[0].handle_or_forward(f"key-{i}", {"i": i}, "fwd", "/op")
        return handled

    async def rep(self, rep_idx: int, waves: int, wave: int):
        """One timed rep of ``waves`` sequential waves of ``wave``
        concurrent requests; returns (req/s, handled_locally)."""
        import asyncio

        t0 = time.perf_counter()
        done = local = 0
        for w in range(waves):
            base = (rep_idx * waves + w) * wave
            results = await asyncio.gather(*(self.one(base + i) for i in range(wave)))
            done += len(results)
            local += sum(1 for h in results if h)
        return done / (time.perf_counter() - t0), local

    async def close(self):
        import asyncio

        for rp in self.rps:
            rp.destroy()
        # each close joins its link threads: close them together
        await asyncio.gather(*(ch.close() for ch in self.chans))


def bench_forward_comparator(seed: int, full: bool, device=None) -> dict:
    """The minimal-proxy fixture (``_MinimalProxy``) measured with the
    same wave/rep method as ``forward``."""
    import asyncio

    n_req = 5000 if full else 500
    wave = 100  # concurrent client connections, each strictly RTT-bound
    per_conn = max(1, n_req // wave)

    async def run():
        proxy = await _MinimalProxy().start(wave)
        reps, warm_reps = (5, 2) if full else (3, 1)
        qps = []
        for rep in range(warm_reps + reps):
            q = await proxy.rep(rep, per_conn)
            if rep >= warm_reps:
                qps.append(q)
        proxy.close()
        return sorted(qps)

    qps = asyncio.run(run())
    return {
        "metric": "forward_comparator_qps_minimal_proxy",
        "value": round(qps[len(qps) // 2], 0),
        "unit": "req_per_s",
        "qps_reps": [round(q) for q in qps],
        "n_requests_per_rep": wave * per_conn,
    }


def bench_sweep100k(seed: int, full: bool, device=None) -> dict:
    from ringpop_tpu_torch.sim.delta import DeltaFaults
    from ringpop_tpu_torch.sim.lifecycle import LifecycleSim

    dev = _device(device)
    n = 100_000 if full else 20_000
    sweep = {}
    rng = np.random.default_rng(seed)
    victims = sorted(rng.choice(n, size=20, replace=False).tolist())
    up = np.ones(n, bool)
    up[victims] = False
    faults = DeltaFaults(up=torch.from_numpy(up).to(dev))
    states = []
    t0 = time.perf_counter()
    for suspect_ticks in (5, 25, 50):
        sim = LifecycleSim(n=n, k=256, seed=seed, suspect_ticks=suspect_ticks, rng="counter", device=dev)
        ticks, ok = sim.run_until_detected(victims, faults, max_ticks=4000)
        sweep[str(suspect_ticks)] = {"ticks": ticks, "detected": ok}
        states.append(sim.state)
    elapsed = time.perf_counter() - t0
    LAST_RUN["sweep100k"] = {"states": states}
    return {
        "metric": f"lifecycle_{n // 1000}k_suspicion_sweep",
        "value": round(elapsed, 3),
        "unit": "s_total",
        "n_nodes": n,
        "sweep": sweep,
    }


def bench_partition1m(seed: int, full: bool, device=None) -> dict:
    from ringpop_tpu_torch.sim.delta import DeltaFaults, DeltaSim

    dev = _device(device)
    n = 1_000_000 if full else 50_000
    k = 128 if full else 64
    group = np.zeros(n, np.int32)
    group[: int(0.3 * n)] = 1
    part = DeltaFaults(up=torch.ones(n, dtype=torch.bool, device=dev), group=torch.from_numpy(group).to(dev))
    heal = DeltaFaults(up=torch.ones(n, dtype=torch.bool, device=dev))

    sink = _telemetry_sink("partition1m", "delta", {"n": n, "k": k, "seed": seed})
    sim = DeltaSim(n=n, k=k, seed=seed, rng="counter", telemetry_sink=sink, device=dev)
    try:
        t0 = time.perf_counter()
        # partition phase: dissemination proceeds within each side only
        t_part, _ = sim.run_until_converged(part, max_ticks=256)
        # heal phase: cross-side exchange completes global convergence
        t_heal, ok = sim.run_until_converged(heal, max_ticks=4096)
        _sync(dev)
        elapsed = time.perf_counter() - t0
    finally:
        _close_sink(sink)  # a dying bench must still flush its journal tail
    LAST_RUN["partition1m"] = {"states": [sim.state]}
    return {
        "metric": f"delta_{n // 1000}k_30pct_partition_heal",
        "value": round(elapsed, 3),
        "unit": "s",
        "partition_ticks": t_part,
        "heal_ticks": t_heal,
        "converged": ok,
        "n_nodes": n,
    }


def bench_partition_lifecycle(seed: int, full: bool, device=None) -> dict:
    """Detection and convergence separated, at scale: crash 0.1 % of the
    cluster, detect; a 30 % partition then blips for ``blip_ticks`` and
    heals, so literal convergence (no rumor in flight, every live view
    checksum equal) must wait for the falsely accused to refute:
    ``converge_extra_ticks > 0`` (the JAX row's docstring has the
    reasoning)."""
    from ringpop_tpu_torch.sim import lifecycle
    from ringpop_tpu_torch.sim.delta import DeltaFaults

    dev = _device(device)
    n = 1_000_000 if full else 20_000
    k = 256 if full else 64
    blip_ticks = 24  # < suspect_ticks (25): accusations stay refutable suspects
    rng = np.random.default_rng(seed)
    victims = np.sort(rng.choice(n, size=max(4, n // 1000), replace=False))
    up = np.ones(n, bool)
    up[victims] = False
    group = np.zeros(n, np.int32)
    group[: int(0.3 * n)] = 1
    up_t = torch.from_numpy(up).to(dev)
    plain = DeltaFaults(up=up_t)
    blip = DeltaFaults(up=up_t, group=torch.from_numpy(group).to(dev))

    sink = _telemetry_sink("partition_lc", "lifecycle", {"n": n, "k": k, "seed": seed})
    sim = lifecycle.LifecycleSim(n=n, k=k, seed=seed, rng="counter", telemetry=sink, device=dev)
    try:
        # phase 1: headline failure detection, no partition
        t0 = time.perf_counter()
        detect_ticks, detected = sim.run_until_detected(
            victims.tolist(), plain, max_ticks=4096, check_every=16, blocks_per_dispatch=8, time_budget_s=2400.0,
        )
        _sync(dev)
        detect_s = time.perf_counter() - t0

        # phase 2: the 30% partition blips and heals late
        t0 = time.perf_counter()
        sim.run(blip_ticks, blip)
        _sync(dev)
        blip_s = time.perf_counter() - t0

        # the blip left the cluster detected-but-not-converged
        cs = lifecycle.view_checksums(sim.state, plain).cpu().numpy()
        views_agree_after_blip = bool(len(np.unique(cs[up])) == 1)

        # phase 3 (healed): literal convergence, 4-tick checks
        t0 = time.perf_counter()
        extra_ticks, converged = sim.run_until_converged(
            plain, max_ticks=4096, check_every=4, blocks_per_dispatch=8, time_budget_s=2400.0,
        )
        _sync(dev)
        converge_s = time.perf_counter() - t0
    finally:
        _close_sink(sink)  # a dying bench must still flush its journal tail
    LAST_RUN["partition_lc"] = {"states": [sim.state], "sim": sim, "faults": plain}

    return {
        "metric": f"lifecycle_{n // 1000}k_30pct_partition_blip_heal",
        "value": round(detect_s + blip_s + converge_s, 3),
        "unit": "s",
        "n_nodes": n,
        "n_rumor_slots": k,
        "n_victims": int(len(victims)),
        "detect_ticks": detect_ticks,
        "detected": detected,
        "detect_s": round(detect_s, 3),
        "blip_ticks": blip_ticks,
        "blip_s": round(blip_s, 3),
        "views_agree_after_blip": views_agree_after_blip,
        "converge_extra_ticks": extra_ticks,
        "converged": converged,
        "converge_s": round(converge_s, 3),
    }


def bench_ring1m(seed: int, full: bool, device=None) -> dict:
    from ringpop_tpu_torch.hashing.farm import pack_strings
    from ringpop_tpu_torch.ops.hash_ops import keyed_owner_lookup, upload_keys
    from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens, ring_lookup

    dev = _device(device)
    # 256 vnodes/server per the BASELINE config line
    n_servers = 4096 if full else 512
    replicas = 256
    batch = 1_000_000 if full else 100_000
    servers = [f"10.0.{i // 256}.{i % 256}:3000" for i in range(n_servers)]
    t0 = time.perf_counter()
    tokens, owners = build_ring_tokens(servers, replicas, device=dev)
    build_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed)
    hashes = torch.from_numpy(rng.integers(0, 2**32, size=batch, dtype=np.uint32).astype(np.int64)).to(dev)
    out = ring_lookup(tokens, owners, hashes)
    _sync(dev)  # warm
    t0 = time.perf_counter()
    iters = 10
    for _ in range(iters):
        out = ring_lookup(tokens, owners, hashes)
    _sync(dev)
    qps = batch * iters / (time.perf_counter() - t0)

    # fused keyed path: hash raw keys on the device (Fingerprint32) then look up owners
    n_keys = 100_000 if full else 20_000
    keys = [f"user:{i}:{i * 37}" for i in range(n_keys)]
    mat, lens = pack_strings([s.encode() for s in keys])
    dmat, dlens = upload_keys(mat, lens, device=dev)
    out2 = keyed_owner_lookup(tokens, owners, dmat, dlens)
    _sync(dev)  # builds and loads the kernel on the card, warms
    t0 = time.perf_counter()
    for _ in range(iters):
        out2 = keyed_owner_lookup(tokens, owners, dmat, dlens)
    _sync(dev)
    keyed_qps = n_keys * iters / (time.perf_counter() - t0)

    # 1% churn: remove + add servers, rebuild the token arrays
    n_churn = max(1, n_servers // 100)
    t0 = time.perf_counter()
    survivors = servers[n_churn:] + [f"10.9.{i // 256}.{i % 256}:3000" for i in range(n_churn)]
    tokens2, owners2 = build_ring_tokens(survivors, replicas, device=dev)
    ring_lookup(tokens2, owners2, hashes[:1024])
    _sync(dev)
    rebalance_s = time.perf_counter() - t0
    LAST_RUN["ring1m"] = {"tokens": tokens, "owners": owners, "hashes": hashes, "owners_batch": out,
                          "keys": (mat, lens), "owners_keyed": out2}

    return {
        "metric": f"ring_lookup_{n_servers * replicas // 1000}k_vnodes",
        "value": round(qps, 0),
        "unit": "lookups_per_s",
        "build_s": round(build_s, 3),
        "keyed_hash_lookup_qps": round(keyed_qps, 0),
        "churn_rebalance_s": round(rebalance_s, 3),
        "n_servers": n_servers,
        "replica_points": replicas,
        "batch": batch,
    }


def bench_forward_qps(seed: int, full: bool, device=None) -> dict:
    """Keyed requests through handle_or_forward on a live 3-node TCP
    cluster (``_FwdCluster``): ~2/3 proxy to the owner over the wire."""
    import asyncio

    n_req = 5000 if full else 500  # per rep; short reps are noise-dominated
    wave = 500
    waves = max(1, n_req // wave)

    async def run():
        cluster = await _FwdCluster().start()
        reps, warm_reps = (5, 4) if full else (3, 1)
        qps, local, total = [], 0, 0
        for rep in range(warm_reps + reps):
            q, l = await cluster.rep(rep, waves, wave)
            if rep >= warm_reps:
                qps.append(q)
                local += l
                total += waves * wave
        await cluster.close()
        return sorted(qps), local, total

    qps, local, total = asyncio.run(run())
    return {
        "metric": "forward_keyed_qps_3node",
        "value": round(qps[len(qps) // 2], 0),
        "unit": "req_per_s",
        "qps_reps": [round(q) for q in qps],
        "n_requests": total,
        "handled_locally": local,
        "forwarded": total - local,
    }


def bench_forward_ab(seed: int, full: bool, device=None) -> dict:
    """The full forwarding path (``_FwdCluster``) and the minimal-proxy
    comparator (``_MinimalProxy``) in interleaved reps inside one run, so
    drift hits both sides of each pair."""
    import asyncio

    n_req = 5000 if full else 500
    comp_wave = 100
    per_conn = max(1, n_req // comp_wave)
    wave = 500
    waves = max(1, n_req // wave)

    async def run():
        cluster = await _FwdCluster().start()
        proxy = await _MinimalProxy().start(comp_wave)
        reps, warm_reps = (5, 4) if full else (3, 1)
        full_qps, comp_qps = [], []
        for rep in range(warm_reps + reps):
            f, _ = await cluster.rep(rep, waves, wave)
            c = await proxy.rep(rep, per_conn)
            if rep >= warm_reps:
                full_qps.append(f)
                comp_qps.append(c)
        await cluster.close()
        proxy.close()
        return full_qps, comp_qps

    full_qps, comp_qps = asyncio.run(run())
    ratios = sorted(f / c for f, c in zip(full_qps, comp_qps))
    ratio_median = ratios[len(ratios) // 2]
    return {
        "metric": "forward_vs_comparator_paired",
        "value": round(ratio_median, 4),
        "unit": "qps_ratio_full_over_minimal",
        "protocol_overhead_pct_median": round((1.0 - ratio_median) * 100.0, 1),
        "ratio_reps": [round(r, 4) for r in ratios],
        "forward_qps_reps": sorted(round(q) for q in full_qps),
        "comparator_qps_reps": sorted(round(q) for q in comp_qps),
        "n_requests_per_rep": n_req,
    }


def bench_mc_churn(seed: int, full: bool, device=None) -> dict:
    """Detection latency for a fixed victim set under per-replica
    background churn (``detection_latency_under_churn``), its cliff and, at
    full scale, the K / maxP contrast at the saturating dose."""
    from ringpop_tpu_torch.sim.lifecycle import LifecycleParams
    from ringpop_tpu_torch.sim.montecarlo import detection_latency_under_churn
    from ringpop_tpu_torch.sim.scenarios import locate_cliff

    dev = _device(device)
    n = 4096 if full else 512
    b = 32 if full else 8
    churn_max = n // 32  # up to ~3% of the cluster crashing in the background
    rng = np.random.default_rng(seed)
    victims = sorted(rng.choice(n, size=4, replace=False).tolist())
    out = detection_latency_under_churn(
        n=n, seeds=range(seed, seed + b), victims=victims, churn_max=churn_max, k=32, max_ticks=4096,
        churn_seed=seed + 777, device=dev,
    )
    spread = (
        None
        if out["ticks_median"] is None or out["ticks_p90"] is None
        else out["ticks_p90"] - out["ticks_median"]
    )
    cliff_at, cliff_jump = locate_cliff(out["churn_ticks"])
    contrast = None
    if full:
        base_p = LifecycleParams(n=n, k=32)
        contrast = {"maxp_default": base_p.resolved_max_p()}
        for label, kw in (
            ("k32_maxp_default", dict(k=32)),
            ("k32_maxp_x3", dict(k=32, max_p=3 * base_p.resolved_max_p())),
            ("k64_maxp_default", dict(k=64)),
        ):
            o = detection_latency_under_churn(
                n=n, seeds=[seed, seed + 1], victims=victims, churn_max=churn_max, max_ticks=4096,
                churn_seed=seed + 778, device=dev, **kw,
            )
            contrast[label] = o["churn_ticks"]
    return {
        "metric": f"mc_churn_detection_n{n}_x{b}",
        "value": -1.0 if out["ticks_median"] is None else out["ticks_median"],
        "unit": "ticks_median",
        "ticks_p90": out["ticks_p90"],
        "ticks_max": out["ticks_max"],
        "p90_minus_median": spread,
        "churn_max": churn_max,
        "replicas": out["n_replicas"],
        "all_detected": out["detected"] == out["n_replicas"],
        "detected": out["detected"],
        "churn_ticks": out["churn_ticks"],
        "churn_cliff_at": cliff_at,
        "cliff_jump_ticks": cliff_jump,
        "k": 32,
        "cliff_contrast": contrast,
    }


def bench_mc_chaos(seed: int, full: bool, device=None) -> dict:
    """The batched chaos fleet: the mc_churn cliff as a churn x loss
    response surface over one stacked-FaultPlan grid
    (``sim/scenarios.py``), the batched-vs-sequential throughput A/B (the
    sequential pass certifies the whole surface tick for tick), and the
    scored journal over the grid."""
    from ringpop_tpu_torch.sim import scenarios, telemetry
    from ringpop_tpu_torch.sim.lifecycle import LifecycleParams

    dev = _device(device)
    n = 4096 if full else 512
    b_doses = 32 if full else 8
    churn_max = n // 32
    k = 32
    losses = (0.0, 0.02, 0.05, 0.1)
    rng = np.random.default_rng(seed)
    victims = sorted(rng.choice(n, size=4, replace=False).tolist())
    doses = scenarios.mc_churn_doses(b_doses, churn_max)
    params = LifecycleParams(n=n, k=k)
    plan, meta = scenarios.scenario_grid(
        n, victims=victims, doses=doses, losses=losses, churn_seed=seed + 777, device=dev
    )
    seeds = scenarios.grid_seeds(meta, seed)

    # -- 1: the churn x loss surface, one fleet run through the front door
    t0 = time.perf_counter()
    ticks, detected, aot_info = scenarios.detect_surface(
        params, plan, seeds, victims, max_ticks=4096, check_every=1, aot="mc_chaos", device=dev,
    )
    surface_s = time.perf_counter() - t0
    tick_vals = [int(t) if d else None for t, d in zip(ticks, detected)]
    surface = scenarios.response_surface(meta, tick_vals, rows="loss", cols="churn")
    cliffs = {}
    for loss, row in zip(surface["rows"], surface["cells"]):
        at, jump = scenarios.locate_cliff(list(zip(surface["cols"], row)))
        cliffs[str(loss)] = {"cliff_at": at, "jump_ticks": jump}

    # -- 2: batched vs sequential throughput (the sequential pass doubles as
    # a whole-surface certificate); the port compiles no program a point, so
    # its "fresh" and warm sequential passes run the same path
    t0 = time.perf_counter()
    seq_t, seq_d = scenarios.sequential_detect(
        params, plan, seeds, victims, max_ticks=4096, check_every=1, fresh_compile=True, device=dev,
    )
    seq_ab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm_t, _ = scenarios.sequential_detect(
        params, plan, seeds, victims, max_ticks=4096, check_every=1, fresh_compile=False, device=dev,
    )
    seq_warm_s = time.perf_counter() - t0
    batched_ab_s = surface_s
    b_ab = len(meta)
    ab_equal = [int(a) for a in ticks] == [int(s) for s in seq_t] and (
        [int(a) for a in ticks] == [int(w) for w in warm_t]
    )
    ticks_run = max(int(t) for t in ticks) if bool(np.asarray(detected).all()) else 4096
    ab_work = int(b_ab * ticks_run * n)

    # -- 3: scored journal over the full grid
    sink = _telemetry_sink(
        "mc_chaos", "lifecycle",
        {"n": n, "k": k, "seed": seed, "grid": {"doses": doses, "losses": list(losses)}},
    )
    if sink is None:
        sink = telemetry.TelemetrySink()
    horizon = 256
    try:
        t0 = time.perf_counter()
        scores = scenarios.scored_fleet(
            params, plan, meta, seeds, horizon=horizon, journal_every=16, sink=sink, device=dev,
        )
        scored_s = time.perf_counter() - t0
    finally:
        _close_sink(sink)
    fp_surface = scenarios.response_surface(
        meta, [s["false_positive_suspects"] for s in scores], rows="loss", cols="churn",
    )
    detect_frac_surface = scenarios.response_surface(
        meta, [s["final_detect_frac"] for s in scores], rows="loss", cols="churn",
    )

    loss0 = cliffs.get("0.0", {})
    return {
        "metric": f"mc_chaos_surface_n{n}_g{len(meta)}",
        "value": round(seq_ab_s / batched_ab_s, 2),
        "unit": "x_speedup_vs_sequential",
        "n_nodes": n,
        "k": k,
        "grid": {"doses": doses, "losses": list(losses), "b_total": len(meta)},
        "surface_wall_s": round(surface_s, 2),
        "detected": int(np.asarray(detected).sum()),
        "surface": surface,
        "cliff_by_loss": cliffs,
        "churn_cliff_at": loss0.get("cliff_at"),
        "cliff_jump_ticks": loss0.get("jump_ticks"),
        "cache_hit": aot_info.get("cache_hit"),
        "compile_s": aot_info.get("compile_s"),
        "aot_error": aot_info.get("error"),
        "cache_dir": aot_info.get("cache_dir"),
        "throughput": {
            "b": b_ab,
            "max_ticks": 4096,
            "batched_s": round(batched_ab_s, 2),
            "sequential_s": round(seq_ab_s, 2),
            "sequential_warm_s": round(seq_warm_s, 2),
            "speedup": round(seq_ab_s / batched_ab_s, 2),
            "speedup_vs_warm": round(seq_warm_s / batched_ab_s, 2),
            "ticks_equal": ab_equal,
            "batched_rtn_per_s": round(ab_work / batched_ab_s, 0),
            "sequential_rtn_per_s": round(ab_work / seq_ab_s, 0),
        },
        "scored": {
            "horizon": horizon,
            "wall_s": round(scored_s, 2),
            "scores": len(scores),
            "false_positive_surface": fp_surface,
            "final_detect_frac_surface": detect_frac_surface,
        },
    }


# -- the fleet twin: one small grid over a (batch x node x rumor) mesh ----------


def _fleet_twin_grid(seed: int, n: int, k: int, device):
    from ringpop_tpu_torch.sim import lifecycle, scenarios

    params = lifecycle.LifecycleParams(n=n, k=k, suspect_ticks=10, rng="counter")
    rng = np.random.default_rng(seed)
    victims = sorted(rng.choice(n, size=4, replace=False).tolist())
    plan, meta = scenarios.scenario_grid(
        n, victims=victims, doses=[0, n // 64, n // 32], losses=(0.0, 0.05), churn_seed=seed + 777, device=device,
    )
    return params, plan, meta, scenarios.grid_seeds(meta, seed)


def _fleet_twin_rank(mesh, payload: dict) -> dict:
    """One rank of the fleet twin: the grid's fleet over the fleet mesh,
    ``ticks`` ticks with telemetry, and the fetched records (whole on
    every rank)."""
    from ringpop_tpu_torch.sim.montecarlo import MonteCarlo

    params, plan, _meta, seeds = _fleet_twin_grid(payload["seed"], payload["n"], payload["k"], mesh.device)
    mc = MonteCarlo(params, seeds, telemetry=True, mesh=mesh, device=mesh.device)
    mc.advance(payload["ticks"], plan)
    return {"records": mc.fetch_telemetry(plan), "transport": mesh.transport}


def _fleet_sharded_twin(seed: int, n: int, k: int, ticks: int = 24, device=None) -> dict:
    """Certify the fleet's batch-axis mesh partition-invariant: the same
    small scenario grid unsharded here and over a 2x2x2 (batch x node x
    rumor) mesh of 8 rank processes ((2, 4, 1) when k does not supply two
    32-slot word blocks) must give equal per-scenario records."""
    from ringpop_tpu_torch.sim.montecarlo import MonteCarlo

    dev = _device(device)
    shape = (2, 2, 2) if k % 64 == 0 else (2, 4, 1)
    try:
        params, plan, meta, seeds = _fleet_twin_grid(seed, n, k, dev)
        mc_u = MonteCarlo(params, seeds, telemetry=True, device=dev)
        mc_u.advance(ticks, plan)
        ru = mc_u.fetch_telemetry(plan)
        ranks = _rank_group(shape, [("twin", "fleet_twin", {"seed": seed, "n": n, "k": k, "ticks": ticks})], dev)
    except RuntimeError as e:
        return {"equal": False, "error": "fleet twin group failed: " + str(e)[-300:]}
    rs = ranks[0]["twin"]["records"]
    equal = len(ru) == len(rs) and all(a == b for a, b in zip(ru, rs))
    return dict(
        equal=equal, b=len(meta), n=n, k=k, ticks=ticks,
        digests=[r["state_digest"] for r in ru],
        mesh="x".join(str(s) for s in shape)
        + f" (batch x node x rumor), 8 rank processes over {ranks[0]['twin']['transport']}",
    )


def bench_fleet_scale(seed: int, full: bool, device=None) -> dict:
    """The scenario fleet at scale: the process-sliced sweep at P = 1 and
    P = 2 (saved mid-sweep) with peak RSS, the restore at P = 1, the fleet
    mesh twin, and the adaptive cliff search against the dense grid (the
    JAX row's docstring has each leg's certificate)."""
    import os
    import tempfile

    from ringpop_tpu_torch.sim import scenarios
    from ringpop_tpu_torch.sim.lifecycle import LifecycleParams

    dev = _device(device)
    launch, _ = _mh_launch()
    worker = ["-m", "ringpop_tpu_torch.cli.fleet_bench"]
    rank_dev = _rank_device(dev)

    # -- legs 1+2: process-sharded sweep, RSS, mid-sweep save, restore
    if full:
        n, k, b_doses, losses = 4096, 64, 512, "0.0,0.05,0.1,0.15"
    else:
        n, k, b_doses, losses = 512, 16, 16, "0.0,0.1"
    horizon, journal_every, save_at = 32, 16, 16
    grid_args = [
        "--n", str(n), "--k", str(k), "--b-doses", str(b_doses),
        "--losses", losses, "--seed", str(seed),
        "--horizon", str(horizon), "--journal-every", str(journal_every),
        "--suspect-ticks", "10",
    ]
    ck = os.path.join(tempfile.mkdtemp(prefix="fleet_scale_"), "ck")
    t0 = time.perf_counter()
    r1 = launch(1, worker + ["sweep"] + grid_args, timeout_s=3600, device=rank_dev)
    p1_wall = time.perf_counter() - t0
    rec1 = r1[0]["records"][0]
    t0 = time.perf_counter()
    r2 = launch(2, worker + ["sweep", "--save-at", str(save_at), "--path", ck] + grid_args, timeout_s=3600,
                device=rank_dev)
    p2_wall = time.perf_counter() - t0
    dig2: dict = {}
    scores2: list = []
    for r in r2:
        rec = r["records"][0]
        dig2.update(rec["digests"])
        scores2 += rec["scores"]
    scores2.sort(key=lambda s: s["scenario_id"])
    r3 = launch(1, worker + ["sweep-restore", "--path", ck] + grid_args, timeout_s=3600, device=rank_dev)
    rec3 = r3[0]["records"][0]

    b_total = rec1["b"]
    digests_equal = rec1["digests"] == dig2
    scores_equal = rec1["scores"] == scores2
    restore_exact = rec1["digests"] == rec3["digests"] and rec1["scores"] == rec3["scores"]
    rss_p1 = rec1["peak_rss_mb"]
    rss_p2 = max(r["records"][0]["peak_rss_mb"] for r in r2)
    rss_frac = round(rss_p2 / rss_p1, 3) if rss_p1 else None

    # -- leg 3: the fleet mesh twin
    twin = _fleet_sharded_twin(seed, n=n if full else 512, k=k if full else 16, device=dev)

    # -- leg 4: adaptive vs dense cliff search
    params_ad = LifecycleParams(n=n, k=32 if full else k)
    rng = np.random.default_rng(seed)
    ad_victims = sorted(rng.choice(n, size=4, replace=False).tolist())
    ad_kw = dict(
        victims=ad_victims,
        losses=(0.0,),
        max_dose=128 if full else 64,
        churn_seed=seed + 777,
        max_ticks=4096,
        check_every=1,
        seeds_per_point=3 if full else 1,
    )
    t0 = time.perf_counter()
    ad = scenarios.refine_surface(params_ad, coarse=9, aot="fleet_refine", device=dev, **ad_kw)
    ad_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    de = scenarios.dense_surface(params_ad, device=dev, **ad_kw)
    de_wall = time.perf_counter() - t0
    cliffs_match = all(
        ad["cliffs"][l]["cliff_at"] == de["cliffs"][l]["cliff_at"] and ad["cliffs"][l]["cliff_at"] is not None
        for l in ad_kw["losses"]
    )
    evals_ratio = round(ad["evals_unique"] / de["evals_unique"], 4)

    certified = bool(
        digests_equal and scores_equal and restore_exact
        and rss_frac is not None and rss_frac < 0.75
        and twin.get("equal")
        and cliffs_match and evals_ratio <= 0.25
    )
    return {
        "metric": f"fleet_scale_n{n}_b{b_total}",
        "value": rss_frac,
        "unit": "rss_frac_p2_over_p1",
        "certified": certified,
        "n_nodes": n,
        "k": k,
        "b": b_total,
        "horizon": horizon,
        "journal_every": journal_every,
        "digests_equal": digests_equal,
        "scores_equal": scores_equal,
        "restore_exact": restore_exact,
        "restored_from": rec3.get("resumed"),
        "rss_p1_mb": rss_p1,
        "rss_p2_max_mb": rss_p2,
        "rss_frac": rss_frac,
        "p1_wall_s": round(p1_wall, 2),
        "p2_wall_s": round(p2_wall, 2),
        "save_s": next(
            (r["records"][0].get("save_s") for r in r2 if r["records"][0].get("save_s") is not None), None,
        ),
        "twin": twin,
        "adaptive": {
            "cliffs": {str(l): ad["cliffs"][l] for l in ad_kw["losses"]},
            "dense_cliffs": {str(l): de["cliffs"][l] for l in ad_kw["losses"]},
            "cliffs_match": cliffs_match,
            "evals_adaptive": ad["evals_unique"],
            "evals_dense": de["evals_unique"],
            "evals_ratio": evals_ratio,
            "dispatches": ad["dispatches"],
            "width": ad["width"],
            "seeds_per_point": ad_kw["seeds_per_point"],
            "compiled_programs": ad.get("compiled_programs"),
            "adaptive_wall_s": round(ad_wall, 2),
            "dense_wall_s": round(de_wall, 2),
            "all_detected": ad.get("all_detected") and de.get("all_detected"),
            "max_dose": ad_kw["max_dose"],
            "cache_hit": ad.get("aot", {}).get("cache_hit"),
            "compile_s": ad.get("aot", {}).get("compile_s"),
        },
    }


# -- chaos-plane scenarios (sim/chaos.py) ------------------------------------

# certificates already computed in this process, by their arguments and
# the device's kind: several rows' twins can come from one rank group
_TWIN_MEMO: dict = {}


def _twin_plan(name: str, builder: str, n: int, seed: int, horizon: int, device):
    from ringpop_tpu_torch.sim import chaos, topology

    build = topology.topo_scenario_plan if builder == "topo" else chaos.scenario_plan
    return build(name, n, seed=seed, horizon=horizon, device=device)


def _twin_params(n: int, k: int):
    from ringpop_tpu_torch.sim import lifecycle

    return lifecycle.LifecycleParams(n=n, k=k, suspect_ticks=6, rng="counter")


def _chaos_twin_rank(mesh, specs: list) -> dict:
    """One rank of the chaos twins: each spec's plan over the mesh for its
    ticks; its digest combined on every rank, its leaves gathered and
    digested on the lead rank."""
    from ringpop_tpu_torch.parallel import partition
    from ringpop_tpu_torch.parallel.mesh import with_exchange_mesh
    from ringpop_tpu_torch.sim import lifecycle, telemetry

    lead = mesh.coords == {"node": 0, "rumor": 0}
    out = {"transport": mesh.transport}
    for spec in specs:
        name, seed, n, k, ticks, horizon, builder = spec
        sp = with_exchange_mesh(_twin_params(n, k), mesh)
        plan = _twin_plan(name, builder, n, seed, horizon, mesh.device)
        sout = lifecycle._run_block(sp, lifecycle.init_state(sp, seed=seed), plan, ticks)
        digest = int(telemetry.tree_digest(sout, mesh))
        leaves = partition.host_gather(sout, mesh)
        out[repr(tuple(spec))] = {"digest": digest, "sha": _leaf_sha(leaves) if lead else None}
    return out


def chaos_twins(specs: list, device=None) -> list:
    """The chaos rows' sharded-twin certificates for ``specs`` (tuples of
    ``(name, seed, n, k, ticks, horizon, builder)``), the ones not yet
    memoized computed together: each plan unsharded here, then all of them
    over one 4 x 2 mesh of 8 rank processes.  Each certificate is its own
    plan's.  A group that fails gives every one of its specs ``equal``
    False and the error."""
    from ringpop_tpu_torch.sim import lifecycle, telemetry

    dev = _device(device)
    todo = [tuple(s) for s in specs if (dev.type, tuple(s)) not in _TWIN_MEMO]
    todo = list(dict.fromkeys(todo))
    if todo:
        refs = {}
        try:
            for spec in todo:
                name, seed, n, k, ticks, horizon, builder = spec
                params = _twin_params(n, k)
                ref = lifecycle._run_block(params, lifecycle.init_state(params, seed=seed, device=dev),
                                           _twin_plan(name, builder, n, seed, horizon, dev), ticks)
                refs[spec] = (int(telemetry.tree_digest(ref)), _leaf_sha(ref))
                del ref
            size = MESH_SHAPE[0] * MESH_SHAPE[1]
            lead = _rank_group(MESH_SHAPE, [("twins", "chaos_twin", todo)], dev)[0]["twins"]
        except RuntimeError as e:
            for spec in todo:
                _TWIN_MEMO[(dev.type, spec)] = {"equal": False, "error": "twin group failed: " + str(e)[-300:]}
        else:
            for spec in todo:
                name, seed, n, k, ticks, horizon, builder = spec
                got = lead[repr(spec)]
                _TWIN_MEMO[(dev.type, spec)] = dict(
                    digest_unsharded=refs[spec][0], digest_sharded=got["digest"],
                    equal=refs[spec][1] == got["sha"] and refs[spec][0] == got["digest"],
                    n=n, k=k, ticks=ticks,
                    mesh=f"4x2 (node x rumor), {size} rank processes over {lead['transport']}")
    return [dict(_TWIN_MEMO[(dev.type, tuple(s))]) for s in specs]


def _twin_spec(name: str, seed: int, n=4096, k=64, ticks=24, horizon=64, builder: str = "chaos") -> tuple:
    return (name, seed, n, k, ticks, horizon, builder)


def remember_twin(spec: tuple, certificate: dict, device=None) -> None:
    """Memoize a twin certificate computed elsewhere for ``spec`` (a caller
    that already ran the same plan unsharded and over a 4 x 2 mesh of rank
    processes on this device, such as the chip smoke's rumor-axis phase):
    the rows then take it instead of starting a group of their own."""
    dev = _device(device)
    _TWIN_MEMO[(dev.type, tuple(spec))] = dict(certificate)


def _chaos_sharded_twin(name: str, seed: int, n=4096, k=64, ticks=24, horizon=64, builder: str = "chaos",
                        device=None) -> dict:
    """Certify the scenario's FaultPlan partition-invariant: the same plan
    (``chaos.scenario_plan``, or ``topology.topo_scenario_plan`` with
    ``builder="topo"``) unsharded and over the 4 x 2 mesh, state digests
    and every leaf compared (:func:`chaos_twins`, memoized)."""
    return chaos_twins([_twin_spec(name, seed, n, k, ticks, horizon, builder)], device)[0]


def _run_chaos_scenario(scenario: str, plan_name: str, n: int, k: int, horizon: int, seed: int,
                        suspect_ticks: int = 10, journal_every: int = 16, device=None) -> dict:
    """Shared runner for the chaos scenarios: the lifecycle engine under
    the plan for ``horizon`` ticks with telemetry on (journaled to the
    --telemetry file when given), the journal scored
    (``chaos.score_blocks``), the verdict appended, and the sharded-twin
    digest certificate attached."""
    from ringpop_tpu_torch.sim import chaos, telemetry
    from ringpop_tpu_torch.sim.lifecycle import LifecycleSim

    dev = _device(device)
    plan = chaos.scenario_plan(plan_name, n, seed=seed, horizon=horizon, device=dev)
    sink = _telemetry_sink(scenario, "lifecycle", {"n": n, "k": k, "seed": seed})
    if sink is None:
        sink = telemetry.TelemetrySink()  # records still needed for scoring
    sim = LifecycleSim(n=n, k=k, seed=seed, suspect_ticks=suspect_ticks, rng="counter", telemetry=sink, device=dev)
    try:
        sim.run(journal_every, plan)  # the first block: builds and loads the kernels on the card
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(horizon // journal_every - 1):
            sim.run(journal_every, plan)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        score = chaos.score_blocks(sink.records, plan, n=n, scenario=scenario)
        if sink.journal is not None:
            sink.journal.score(score)
    finally:
        _close_sink(sink)
    LAST_RUN[scenario] = {"states": [sim.state], "records": list(sink.records), "score": score}
    twin = _chaos_sharded_twin(plan_name, seed, device=dev)
    return {
        "metric": f"chaos_{scenario}",
        "value": round(elapsed, 3),
        "unit": "s",
        "n_nodes": n,
        "n_rumor_slots": k,
        "ticks": horizon,
        "events": len(score["events"]),
        "time_to_detect_median": score["time_to_detect_median"],
        "rumor_half_life_median": score["rumor_half_life_median"],
        "false_positive_suspects": score["false_positive_suspects"],
        "rejoin_convergence_ticks": score["rejoin_convergence_ticks"],
        "final_detect_frac": score["final_detect_frac"],
        "sharded_digest_equal": twin.get("equal"),
        "sharded_twin": twin,
    }


def bench_churn100k(seed: int, full: bool, device=None) -> dict:
    """Crash/restart churn waves at scale, scored for time-to-detect per
    wave, rumor half-life and re-join convergence."""
    n = 100_000 if full else 8192
    k = 256 if full else 64
    return _run_chaos_scenario("churn100k", "churn", n, k, horizon=256, seed=seed, device=device)


def bench_flap1k(seed: int, full: bool, device=None) -> dict:
    """Flapping members under background loss, scored."""
    del full  # 1k nodes IS the scenario
    return _run_chaos_scenario("flap1k", "flap", 1000, 64, horizon=256, seed=seed, suspect_ticks=8, device=device)


def bench_asym_partition(seed: int, full: bool, device=None) -> dict:
    """A directed partition window over a small permanent crash cohort."""
    n = 50_000 if full else 4096
    return _run_chaos_scenario("asym_partition", "asym", n, 64, horizon=256, seed=seed, device=device)


def bench_topo_chaos(seed: int, full: bool, device=None) -> dict:
    """Topology-realistic fault overlays through the batched fleet with the
    per-tier counters: the per-tier split on every verdict, correlated
    against independent failures (near-tier suspicion share), the WAN
    direction split, and the topology plan's sharded twin."""
    from ringpop_tpu_torch.sim import chaos, scenarios, topology
    from ringpop_tpu_torch.sim.lifecycle import LifecycleParams

    dev = _device(device)
    n = 4096 if full else 512
    k = 32
    horizon = 256
    reps = 2 if full else 1
    topo = topology.default_topology(n)
    plans, meta = topology.topo_scenario_specs(topo, seed=seed, horizon=horizon, reps=reps, device=dev)
    stacked = chaos.stack_plans(plans)
    b = chaos.plan_batch_size(stacked)
    seeds = [seed + i for i in range(len(plans))]
    params = LifecycleParams(n=n, k=k, suspect_ticks=10, rng="counter")

    sink = _telemetry_sink(
        "topo_chaos", "lifecycle",
        {"n": n, "k": k, "seed": seed, "b": b,
         "tree": {"regions": topo.spec.regions, "zones": topo.spec.total_zones, "racks": topo.spec.total_racks},
         "tier_drop": [float(x) for x in topo.tier_drop]},
    )
    try:
        t0 = time.perf_counter()
        scores = scenarios.scored_fleet(
            params, stacked, meta, seeds, horizon=horizon, journal_every=16, sink=sink, scenario="topo_chaos",
            device=dev,
        )
        fleet_s = time.perf_counter() - t0
    finally:
        _close_sink(sink)

    split_present = all(
        isinstance(s.get("suspects_by_tier"), dict)
        and isinstance(s.get("false_positive_by_tier"), dict)
        and isinstance(s.get("time_to_detect_by_tier"), dict)
        for s in scores
    )

    def near_share(score) -> Optional[float]:
        by_tier = score.get("suspects_by_tier") or {}
        total = float(sum(by_tier.values()))
        if total <= 0:
            return None
        return (by_tier.get("same_rack", 0) + by_tier.get("cross_rack", 0)) / total

    def family(event: str) -> list:
        vals = [near_share(s) for s, m in zip(scores, meta) if m["event"] == event]
        return [v for v in vals if v is not None]

    zone_near = family("zone_loss")
    ind_near = family("independent")
    zone_med = float(np.median(zone_near)) if zone_near else None
    ind_med = float(np.median(ind_near)) if ind_near else None
    distinguishes = zone_med is not None and ind_med is not None and ind_med > zone_med

    def fam_ttd(event: str):
        vals = [
            s["time_to_detect_median"]
            for s, m in zip(scores, meta)
            if m["event"] == event and s.get("time_to_detect_median") is not None
        ]
        return float(np.median(vals)) if vals else None

    wan_scores = [s for s, m in zip(scores, meta) if m["event"] == "wan_oneway"]
    wan_split_ok = all(
        s.get("refutations_unreachable_dir") is not None and s.get("refutations_reachable_dir") is not None
        for s in wan_scores
    )

    twin = _chaos_sharded_twin("smoke", seed, builder="topo", device=dev)
    return {
        "metric": f"topo_chaos_n{n}_b{b}",
        "value": round(fleet_s, 2),
        "unit": "s_fleet_wall",
        "n_nodes": n,
        "k": k,
        "b": b,
        "horizon": horizon,
        "tree": {
            "regions": topo.spec.regions,
            "zones": topo.spec.total_zones,
            "racks": topo.spec.total_racks,
            "tier_drop": [round(float(x), 6) for x in topo.tier_drop],
        },
        "events": sorted({m["event"] for m in meta}),
        "per_tier_split_present": split_present,
        "near_tier_share": {"zone_loss_median": zone_med, "independent_median": ind_med},
        "distinguishes_correlated": bool(distinguishes),
        "ttd_median_by_event": {ev: fam_ttd(ev) for ev in ("zone_loss", "independent", "wan", "wan_oneway")},
        "wan_direction_split_present": bool(wan_split_ok),
        "sharded_digest_equal": twin.get("equal"),
        "sharded_twin": twin,
        "certified": bool(split_present and distinguishes and wan_split_ok and twin.get("equal")),
    }


# -- multi-host rows: rank processes through cli/multihost_launch ---------------


def _delta_twin_digest(n: int, k: int, ticks: int, victims: int, drop: Optional[float], seed: int, device) -> int:
    """The in-process engine digest of a multihost twin scenario: the
    port's ``delta.step`` for ``ticks`` ticks (victims drawn as the bench
    draws them, ``drop`` loss unless None)."""
    from ringpop_tpu_torch.sim.delta import DeltaFaults, DeltaParams, init_state, step
    from ringpop_tpu_torch.sim.telemetry import tree_digest

    params = DeltaParams(n=n, k=k, rng="counter")
    rng = np.random.default_rng(seed + 999)
    up = np.ones(n, bool)
    up[rng.choice(n, size=victims, replace=False)] = False
    kw = {"up": torch.from_numpy(up).to(device)}
    if drop is not None:
        kw["drop_rate"] = torch.tensor(drop, dtype=torch.float32, device=device)
    faults = DeltaFaults(**kw)
    st = init_state(params, seed=seed, device=device)
    for _ in range(ticks):
        st = step(params, st, faults)
    return int(tree_digest(st))


def bench_multihost16m(seed: int, full: bool, device=None) -> dict:
    """The same seeded delta scenario at 1/2/4 rank processes over the
    host-bridged fabric (``sim/delta_multihost``): the twin (every process
    count's digest equal to the in-process engine's), the snapshot (a
    2-process save restored at 4 processes and continued) and the scale
    leg (16M nodes; 1M at the non-full size) at P = 1 and 2 with peak RSS
    and fabric MB a tick."""
    import shutil
    import tempfile

    dev = _device(device)
    launch, base = _mh_launch()
    rank_dev = _rank_device(dev)

    # -- leg 1: the 1/2/4-process twin
    tn, tk, tticks, victims, drop = 65536, 64, 24, 64, 0.05
    common = ["--n", str(tn), "--k", str(tk), "--seed", str(seed), "--victims", str(victims), "--drop", str(drop)]
    twin = {}
    for nprocs in (1, 2, 4):
        t0 = time.perf_counter()
        ranks = launch(nprocs, base + ["twin", *common, "--ticks", str(tticks)], timeout_s=900, device=rank_dev)
        recs = [r["records"][-1] for r in ranks]
        twin[str(nprocs)] = {
            "digest": recs[0]["digest"],
            "ranks_agree": len({r["digest"] for r in recs}) == 1,
            "rank_digests": [r["digest"] for r in recs],
            "peak_rss_mb": [r["peak_rss_mb"] for r in recs],
            "wall_s": round(time.perf_counter() - t0, 2),
        }
    engine_digest = _delta_twin_digest(tn, tk, tticks, victims, drop, seed, dev)
    twin_certified = all(v["ranks_agree"] and v["digest"] == engine_digest for v in twin.values())

    # -- leg 2: cross-process-count snapshot
    ckpt = tempfile.mkdtemp(prefix="mh16m_ckpt_")
    shutil.rmtree(ckpt)
    t1, t2 = 16, 8
    snap_common = ["--n", str(tn), "--k", str(tk), "--seed", str(seed), "--victims", str(victims)]
    try:
        ranks = launch(2, base + ["snapshot-save", *snap_common, "--ticks", str(t1), "--path", ckpt], timeout_s=900,
                       device=rank_dev)
        saved_digest = ranks[0]["records"][-1]["digest"]
        ranks = launch(4, base + ["snapshot-restore", *snap_common, "--extra-ticks", str(t2), "--path", ckpt],
                       timeout_s=900, device=rank_dev)
        rest = [r["records"][-1] for r in ranks]
        unbroken = _delta_twin_digest(tn, tk, t1 + t2, victims, None, seed, dev)
        snapshot = {
            "save_procs": 2,
            "restore_procs": 4,
            "digest_at_save": saved_digest,
            "digest_at_restore": rest[0]["digest_at_restore"],
            "digest_continued": rest[0]["digest"],
            "digest_unbroken_reference": unbroken,
            "certified": bool(
                rest[0]["digest_at_restore"] == saved_digest
                and rest[0]["digest"] == unbroken
                and len({r["digest"] for r in rest}) == 1
            ),
        }
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    # -- leg 3: the scale axis through the fabric
    sn = 16_000_000 if full else 1_000_000
    sk = 64
    scale = {}
    scale_common = ["--n", str(sn), "--k", str(sk), "--seed", str(seed), "--max-ticks", "4096",
                    "--journal-every", "64"]
    for nprocs in (1, 2):
        t0 = time.perf_counter()
        ranks = launch(nprocs, base + ["converge", *scale_common], timeout_s=3600, device=rank_dev)
        results = [next(rec for rec in reversed(r["records"]) if rec["kind"] == "result") for r in ranks]
        scale[str(nprocs)] = {
            "ticks": results[0]["ticks"],
            "converged": results[0]["converged"],
            "digest": results[0]["digest"],
            "ranks_agree": len({r["digest"] for r in results}) == 1,
            "wall_s": round(time.perf_counter() - t0, 2),
            "ms_per_tick": results[0]["ms_per_tick"],
            "peak_rss_mb": [r["peak_rss_mb"] for r in results],
            "fabric_mb_per_tick": [r["fabric_mb_per_tick"] for r in results],
        }
    scale_certified = (
        scale["1"]["digest"] == scale["2"]["digest"]
        and scale["1"]["ranks_agree"]
        and scale["2"]["ranks_agree"]
        and scale["1"]["converged"]
        and scale["2"]["converged"]
    )
    rss_1p = max(scale["1"]["peak_rss_mb"])
    rss_2p = max(scale["2"]["peak_rss_mb"])

    return {
        "metric": f"multihost_dcn_{sn // 1_000_000}m",
        "value": round(rss_2p / rss_1p, 3),
        "unit": "rss_frac_2proc_over_1proc",
        "certified": bool(twin_certified and snapshot["certified"] and scale_certified),
        "engine_digest": engine_digest,
        "twin_certified": twin_certified,
        "twin": twin,
        "snapshot": snapshot,
        "scale": scale,
        "scale_certified": scale_certified,
        "exchange_path": "host-bridged fabric (rank processes; the mesh path is certified by sharded100k)",
        "n_nodes": sn,
        "n_rumors": sk,
    }


# the canonical engine-anchored twin scenario every fabric A/B certifies
# against — one definition, so dcn_wire and swing_overlap share the anchor
_MH_TWIN = {"n": 65536, "k": 64, "ticks": 24, "victims": 64, "drop": 0.05}


def _mh_launch():
    """The multihost launcher and the worker argv base the fabric rows
    share (one spawn path: ``cli/multihost_launch``)."""
    from ringpop_tpu_torch.cli.multihost_launch import launch

    return launch, ["-m", "ringpop_tpu_torch.cli.multihost_bench"]


def _mh_twin_common(seed: int) -> list:
    t = _MH_TWIN
    return ["--n", str(t["n"]), "--k", str(t["k"]), "--seed", str(seed),
            "--victims", str(t["victims"]), "--drop", str(t["drop"])]


@_functools.lru_cache(maxsize=None)
def _mh_twin_anchor(seed: int, kind: str = "cuda") -> int:
    """The in-process engine digest of the canonical twin scenario, cached
    so a run covering both fabric rows computes it once."""
    t = _MH_TWIN
    return _delta_twin_digest(t["n"], t["k"], t["ticks"], t["victims"], t["drop"], seed, torch.device(kind))


def bench_dcn_wire(seed: int, full: bool, device=None) -> dict:
    """The wire codec A/B over the host-bridged fabric: the twin with the
    codec on and off (both equal to the engine), then convergence at 16M
    (1M at the non-full size) at P = 2 codec on against off, per-tick
    journals: wire MB a tick, walls, digests."""
    dev = _device(device)
    launch, base = _mh_launch()
    rank_dev = _rank_device(dev)

    common = _mh_twin_common(seed)
    twin = {}
    for codec in ("on", "off"):
        ranks = launch(2, base + ["twin", *common, "--ticks", str(_MH_TWIN["ticks"]), "--codec", codec],
                       timeout_s=900, device=rank_dev)
        recs = [r["records"][-1] for r in ranks]
        twin[codec] = {"digest": recs[0]["digest"], "ranks_agree": len({r["digest"] for r in recs}) == 1}
    engine_digest = _mh_twin_anchor(seed, dev.type)
    twin_certified = all(v["ranks_agree"] and v["digest"] == engine_digest for v in twin.values())

    sn = 16_000_000 if full else 1_000_000
    sk = 64
    scale_common = ["--n", str(sn), "--k", str(sk), "--seed", str(seed), "--max-ticks", "4096",
                    "--journal-every", "1", "--journal-light"]
    scale = {}
    for codec in ("on", "off"):
        t0 = time.perf_counter()
        ranks = launch(2, base + ["converge", *scale_common, "--codec", codec], timeout_s=3600, device=rank_dev)
        results = [next(rec for rec in reversed(r["records"]) if rec["kind"] == "result") for r in ranks]
        r0 = results[0]
        scale[codec] = {
            "ticks": r0["ticks"],
            "converged": r0["converged"],
            "digest": r0["digest"],
            "ranks_agree": len({r["digest"] for r in results}) == 1,
            "wall_s": round(time.perf_counter() - t0, 2),
            "worker_wall_s": [r["wall_s"] for r in results],
            "ms_per_tick": r0["ms_per_tick"],
            "wire_mb_per_tick": [r["fabric_mb_per_tick"] for r in results],
            "raw_mb_per_tick": [r["fabric_raw_mb_per_tick"] for r in results],
            "codec_ratio": r0["fabric_codec_ratio"],
            "codec_counts": r0["fabric_codec_counts"],
            "d2h_mb": [round(r["d2h_bytes"] / 1e6, 2) for r in results],
            "peak_rss_mb": [r["peak_rss_mb"] for r in results],
        }
        blocks = [rec for rec in ranks[0]["records"] if rec["kind"] == "block"]
        scale[codec]["per_tick"] = [
            {
                "tick": b["tick"],
                "coverage": b["coverage"],
                "wire_mb": round(b["fabric_wire_sent_delta"] / 1e6, 3),
                "raw_mb": round(b["fabric_raw_sent_delta"] / 1e6, 3),
                "ratio": b["fabric_codec_ratio"],
            }
            for b in blocks
        ]
    digests_equal = bool(
        scale["on"]["digest"] == scale["off"]["digest"]
        and scale["on"]["ranks_agree"] and scale["off"]["ranks_agree"]
        and scale["on"]["converged"] and scale["off"]["converged"]
        and scale["on"]["ticks"] == scale["off"]["ticks"]
    )
    wire_on = max(scale["on"]["wire_mb_per_tick"])
    wire_off = max(scale["off"]["wire_mb_per_tick"])
    wire_ratio = round(wire_off / wire_on, 3) if wire_on else None
    inline_ratio = scale["on"]["codec_ratio"]
    wall_on = max(scale["on"]["worker_wall_s"])
    wall_off = max(scale["off"]["worker_wall_s"])
    wall_ratio = round(wall_on / wall_off, 3) if wall_off else None
    dissem = [p for p in scale["on"]["per_tick"] if p["coverage"] < 0.999]
    dissem_ratio = (
        round(sum(p["raw_mb"] for p in dissem) / max(sum(p["wire_mb"] for p in dissem), 1e-9), 2)
        if dissem else None
    )

    return {
        "metric": f"dcn_wire_{sn // 1_000_000}m",
        "value": wire_ratio,
        "unit": "wire_compression_x",
        "certified": bool(
            twin_certified and digests_equal
            and wire_ratio is not None and wire_ratio >= 2.0
            and wall_ratio is not None and wall_ratio <= 1.05
        ),
        "engine_digest": engine_digest,
        "twin": twin,
        "twin_certified": twin_certified,
        "scale": scale,
        "digests_equal": digests_equal,
        "wire_mb_per_tick_on": wire_on,
        "wire_mb_per_tick_off": wire_off,
        "wire_ratio": wire_ratio,
        "inline_codec_ratio": inline_ratio,
        "dissemination_ratio": dissem_ratio,
        "wall_ratio_on_over_off": wall_ratio,
        "n_nodes": sn,
        "n_rumors": sk,
    }


def bench_swing_overlap(seed: int, full: bool, device=None) -> dict:
    """The exchange-schedule and cross-tick-pipelining A/B over the
    host-bridged fabric: the twin under every (schedule, overlap), the
    overlap A/B at P = 2 in interleaved reps, and swing against cyclic at
    P = 4 with the relay overhead priced."""
    dev = _device(device)
    launch, base = _mh_launch()
    rank_dev = _rank_device(dev)

    common = _mh_twin_common(seed)
    twin = {}
    for schedule in ("cyclic", "swing"):
        for overlap in ("off", "on"):
            ranks = launch(
                2,
                base + ["twin", *common, "--ticks", str(_MH_TWIN["ticks"]), "--schedule", schedule,
                        "--overlap", overlap],
                timeout_s=900, device=rank_dev,
            )
            recs = [r["records"][-1] for r in ranks]
            twin[f"{schedule}/{overlap}"] = {
                "digest": recs[0]["digest"],
                "ranks_agree": len({r["digest"] for r in recs}) == 1,
                "leg_ms": recs[0]["fabric_leg_ms"],
                "overlap_hidden_ms": recs[0]["overlap_hidden_ms"],
            }
    engine_digest = _mh_twin_anchor(seed, dev.type)
    twin_certified = all(v["ranks_agree"] and v["digest"] == engine_digest for v in twin.values())

    def _converge(n, nprocs, schedule, overlap, journal=True):
        args = ["converge", "--n", str(n), "--k", "64", "--seed", str(seed), "--max-ticks", "4096",
                "--schedule", schedule, "--overlap", overlap]
        if journal:
            args += ["--journal-every", "1", "--journal-light"]
        ranks = launch(nprocs, base + args, timeout_s=3600, device=rank_dev)
        results = [next(rec for rec in reversed(r["records"]) if rec["kind"] == "result") for r in ranks]
        blocks = [rec for rec in ranks[0]["records"] if rec["kind"] == "block"]
        return results, blocks

    # -- leg 2: overlap A/B (cross-tick pipelining must not lose)
    n2 = 1_048_576 if full else 262_144
    reps = 5
    # one untimed launch a mode: the kernels' builds and first loads
    _converge(n2, 2, "cyclic", "off", journal=False)
    _converge(n2, 2, "cyclic", "on", journal=False)
    ab: dict = {"sequential": {"walls": []}, "pipelined": {"walls": []}}
    for rep in range(reps):
        for mode, overlap in (("sequential", "off"), ("pipelined", "on")):
            results, blocks = _converge(n2, 2, "cyclic", overlap)
            r0 = results[0]
            side = ab[mode]
            side["walls"].append(max(r["wall_s"] for r in results))
            side["digest"] = r0["digest"]
            side["ranks_agree"] = len({r["digest"] for r in results}) == 1
            side["ticks"] = r0["ticks"]
            side["converged"] = r0["converged"]
            side["leg_ms"] = r0["fabric_leg_ms"]
            side["overlap_hidden_ms"] = r0["overlap_hidden_ms"]
            side["wire_mb_per_tick"] = r0["fabric_mb_per_tick"]
            side["journal_keys_present"] = bool(blocks) and all(
                "fabric_leg_ms" in b and "overlap_hidden_ms" in b and "schedule" in b for b in blocks
            )
    for side in ab.values():
        side["wall_min"] = min(side["walls"])
        side["wall_median"] = sorted(side["walls"])[len(side["walls"]) // 2]
    ab["digests_equal"] = bool(
        ab["sequential"]["digest"] == ab["pipelined"]["digest"]
        and ab["sequential"]["ranks_agree"] and ab["pipelined"]["ranks_agree"]
        and ab["sequential"]["ticks"] == ab["pipelined"]["ticks"]
        and ab["sequential"]["converged"] and ab["pipelined"]["converged"]
    )
    ab["wall_ratio_min"] = round(ab["pipelined"]["wall_min"] / ab["sequential"]["wall_min"], 3)
    ab["wall_ratio_median"] = round(ab["pipelined"]["wall_median"] / ab["sequential"]["wall_median"], 3)
    overlap_ok = bool(
        ab["digests_equal"]
        and ab["sequential"]["journal_keys_present"]
        and ab["pipelined"]["journal_keys_present"]
        and ab["wall_ratio_min"] <= 1.0
        and ab["pipelined"]["overlap_hidden_ms"] > 0.0
    )

    # -- leg 3: swing A/B at P=4 (relays exist there; P=2 degenerates)
    n4 = 262_144 if full else 65_536
    _converge(n4, 4, "cyclic", "off", journal=False)
    _converge(n4, 4, "swing", "off", journal=False)
    sw: dict = {}
    for schedule in ("cyclic", "swing"):
        walls = []
        for rep in range(3):
            results, _ = _converge(n4, 4, schedule, "off", journal=False)
            r0 = results[0]
            walls.append(max(r["wall_s"] for r in results))
        sw[schedule] = {
            "walls": walls,
            "wall_min": min(walls),
            "digest": r0["digest"],
            "ranks_agree": len({r["digest"] for r in results}) == 1,
            "ticks": r0["ticks"],
            "wire_mb_per_tick": r0["fabric_mb_per_tick"],
            "raw_mb_per_tick": r0["fabric_raw_mb_per_tick"],
            "leg_ms": r0["fabric_leg_ms"],
        }
    sw["digests_equal"] = bool(
        sw["cyclic"]["digest"] == sw["swing"]["digest"]
        and sw["cyclic"]["ranks_agree"] and sw["swing"]["ranks_agree"]
        and sw["cyclic"]["ticks"] == sw["swing"]["ticks"]
    )
    sw["relay_raw_ratio"] = round(sw["swing"]["raw_mb_per_tick"] / sw["cyclic"]["raw_mb_per_tick"], 3)
    sw["wall_ratio_min"] = round(sw["swing"]["wall_min"] / sw["cyclic"]["wall_min"], 3)
    swing_ok = bool(sw["digests_equal"] and sw["wall_ratio_min"] <= 1.05)

    return {
        "metric": "swing_overlap",
        "value": ab["wall_ratio_min"],
        "unit": "pipelined_over_sequential_wall_min",
        "certified": bool(twin_certified and overlap_ok and swing_ok),
        "engine_digest": engine_digest,
        "twin": twin,
        "twin_certified": twin_certified,
        "overlap_ab": {"n": n2, "nprocs": 2, **ab},
        "swing_ab": {"n": n4, "nprocs": 4, **sw},
        "overlap_certified": overlap_ok,
        "swing_certified": swing_ok,
        "n_nodes": n2,
        "n_rumors": 64,
    }


# -- serve rows ----------------------------------------------------------------


def bench_serve_ring(seed: int, full: bool, device=None) -> dict:
    """The serve-the-ring paired A/B (``serve/bench.run_ab``): frontend
    processes through the shared ring on the device against their own host
    bisect walk, interleaved rep by rep; the certificate is bit-identity.
    The DGRO placement pass is scored alongside."""
    from ringpop_tpu_torch.serve.bench import run_ab
    from ringpop_tpu_torch.serve.placement import dgro_place

    dev = _device(device)
    journal = None
    if _TELEMETRY_PATH is not None:
        from ringpop_tpu_torch.sim.telemetry import TelemetryJournal

        journal = TelemetryJournal(_TELEMETRY_PATH, append=True)
        journal.header("serve", "serve_ring", {"seed": seed, "full": full})
    kw = (
        dict(n_servers=64, frontends=4, batch=8192, batches_per_rep=16, reps=5, warm_reps=1, latency_reqs=300)
        if full
        else dict(n_servers=64, frontends=4, batch=4096, batches_per_rep=8, reps=3, warm_reps=1, latency_reqs=150)
    )
    try:
        rec = run_ab(seed=seed, transport="shm", journal=journal, device=dev, **kw)
    finally:
        if journal is not None:
            journal.close()

    _t, _o, report = dgro_place(
        [f"10.8.{i // 256}.{i % 256}:3000" for i in range(kw["n_servers"])],
        100, candidates=8, probes=1 << 14, churn_frac=0.02, seed=seed, device=dev,
    )
    placement = {
        "chosen": report["chosen"],
        "movement_random": report["movement_random"],
        "movement_chosen": report["movement_chosen"],
        "movement_gate_ok": report["movement_chosen"] <= report["movement_random"] + 1e-9,
        "imbalance_random": report["imbalance_random"],
        "imbalance_chosen": report["imbalance_chosen"],
        "excess_movement_all_zero": all(e == 0.0 for e in report["excess_movement"]),
        "default": "random",  # the serving path never runs DGRO unless asked
    }
    certified = bool(
        rec["digest_equal"]
        and rec["generation_pinned"]
        and rec["update_certified"]
        and rec["latency_b1"]["owners_match_oracle"]
    )
    return {
        "metric": "serve_ring_shared_device_tier",
        "value": rec["speedup_median"],
        "unit": "qps_ratio_serve_over_bisect",
        "certified": certified,
        "placement": placement,
        **rec,
    }


def bench_serve_fanin(seed: int, full: bool, device=None) -> dict:
    """Serve at production fan-in: the serve mesh at P = 1, 2, 4 (every
    rank's stream digest equal to the P = 1 oracle), the per-owner batch
    coalescing priced against the naive plane, and quorum reads under a
    FaultPlan that kills owners mid-read."""
    from ringpop_tpu_torch.forward.batch import quorum_chaos_run
    from ringpop_tpu_torch.serve.mesh import run_serve_mesh

    dev = _device(device)
    kw = (
        dict(n_servers=64, replica_points=100, n=3, streams=4, rounds=6, keys_per_stream=8192)
        if full
        else dict(n_servers=16, replica_points=20, n=3, streams=4, rounds=3, keys_per_stream=2048)
    )
    journal = None
    if _TELEMETRY_PATH is not None:
        from ringpop_tpu_torch.sim.telemetry import TelemetryJournal

        journal = TelemetryJournal(_TELEMETRY_PATH, append=True)
        journal.header("serve", "serve_fanin", {"seed": seed, "full": full, **kw})

    try:
        curve = []
        oracle_digest = None
        digests_equal = True
        messages_ok = True
        for nprocs in (1, 2, 4):
            recs = run_serve_mesh(nprocs, seed=seed, device=dev, **kw)
            if oracle_digest is None:
                oracle_digest = recs[0]["digest"]
            digests_equal = digests_equal and all(r["digest"] == oracle_digest for r in recs)
            wall = max(r["wall_s"] for r in recs)
            keys_total = sum(r["keys_total"] for r in recs)
            wire_mb = [round(r["wire"]["bytes_sent"] / 1e6, 3) for r in recs]
            msgs = sum(r["messages_sent"] for r in recs)
            naive = sum(r["messages_naive"] for r in recs)
            if nprocs > 1:
                messages_ok = messages_ok and msgs < naive
            point = {
                "nprocs": nprocs,
                "keys_total": keys_total,
                "wall_s_max": wall,
                "keys_per_s_aggregate": round(keys_total / max(wall, 1e-9)),
                "keys_per_s_per_host": round(keys_total / max(wall, 1e-9) / nprocs),
                "keys_forwarded": sum(r["keys_forwarded_out"] for r in recs),
                "messages": msgs,
                "messages_naive": naive,
                "wire_mb_per_host": wire_mb,
                "raw_mb_per_host": [round(r["wire"]["raw_bytes_sent"] / 1e6, 3) for r in recs],
                "digests": sorted({r["digest"] for r in recs}),
            }
            curve.append(point)
            if journal is not None:
                journal._write({"kind": "serve_mesh", **point})

        quorum = quorum_chaos_run(
            n_servers=8, replica_points=16, r=3, keys_per_tick=kw["keys_per_stream"] // 16,
            horizon=32 if full else 24, seed=seed,
        )
        if journal is not None:
            for blk in quorum["blocks"]:
                journal._write({"kind": "serve_forward", **blk})
            journal._write(quorum["score"])
        quorum_ok = bool(
            quorum["owners_killed"] and quorum["quorum_held"]
            and quorum["answers_agree"] and quorum["rpcs"] < quorum["rpcs_naive"]
        )
        certified = bool(digests_equal and messages_ok and quorum_ok)
        ttd = quorum["score"]["time_to_detect_median"]
        return {
            "metric": "serve_fanin",
            "value": curve[-1]["keys_per_s_per_host"],
            "unit": "keys_per_s_per_host_at_p4",
            "certified": certified,
            "oracle_digest": oracle_digest,
            "digests_equal": digests_equal,
            "messages_below_naive": messages_ok,
            "scaling_curve": curve,
            "lookup_n": kw["n"],
            "n_servers": kw["n_servers"],
            "replica_points": kw["replica_points"],
            "quorum": {
                k: quorum[k]
                for k in ("r", "quorum", "n_servers", "owners_killed", "quorum_held", "answers_agree", "rpcs",
                          "rpcs_naive", "rpc_ratio")
            },
            "quorum_recovery_ticks_median": ttd,
            "quorum_acks_min": quorum["score"].get("quorum_acks_min"),
        }
    finally:
        if journal is not None:
            journal.close()


def bench_gameday(seed: int, full: bool, device=None) -> dict:
    """The closed-loop game day: a correlated failure injected into a live
    P = 2 fleet with the alert rules and the OpsController attached,
    time-to-mitigate judged against the digest-identical no-controller
    twin (``obs/gameday``)."""
    from ringpop_tpu_torch.obs.gameday import bare_digests, gameday_pair

    dev = _device(device)
    n = 128 if full else 64
    horizon = 64 if full else 48
    scenarios_run = ("zone_cut", "switch_flap") if full else ("zone_cut",)
    out: dict = {"metric": "gameday", "n_nodes": n, "horizon": horizon}
    for scenario in scenarios_run:
        pair = gameday_pair(scenario=scenario, n=n, seed=seed, horizon=horizon, device=dev)
        head = bare_digests(scenario=scenario, n=n, seed=seed, horizon=horizon, device=dev)
        on, off = pair["on"], pair["off"]
        drains = [a for a in on["actions"] if a["action"] == "drain" and a["ok"]]
        effects = [a for a in on["actions"] if a["action"] == "effect" and a["ok"]]
        chain_ok = bool(on["chains"]) and all(
            ch and ch[0]["kind"] == "alert" and any(c["kind"] == "action" for c in ch) for ch in on["chains"]
        )
        out[scenario] = {
            "cut_at": on["cut_at"],
            "ttm_on": pair["ttm_on"],
            "ttm_off": pair["ttm_off"],
            "mitigated_earlier": pair["mitigated_earlier"],
            "digest_equal": pair["digest_equal"],
            "digest_matches_head": off["digests"] == head,
            "alerts": len(on["alerts"]),
            "twin_actions": len(off["actions"]),
            "drains_ok": len(drains),
            "effects_ok": len(effects),
            "chain_ok": chain_ok,
            "stray_rules": sorted({a["rule"] for a in on["alerts"]} - {"probe-timeout-spike"}),
        }
    zc = out["zone_cut"]
    out["value"] = round(zc["ttm_on"] / max(zc["ttm_off"], 1), 3)
    out["unit"] = "controller_over_twin_ttm"
    out["certified"] = bool(
        zc["mitigated_earlier"]
        and zc["digest_equal"]
        and zc["digest_matches_head"]
        and zc["twin_actions"] == 0
        and zc["drains_ok"] >= 1
        and zc["effects_ok"] >= 1
        and zc["chain_ok"]
    )
    return out


_RANK_JOBS = {"sharded100k": _sharded100k_rank, "chaos_twin": _chaos_twin_rank, "fleet_twin": _fleet_twin_rank}

BENCHES = {
    "host10": bench_host10,
    "loss1k": bench_loss1k,
    "montecarlo": bench_montecarlo,
    "sweep100k": bench_sweep100k,
    "partition1m": bench_partition1m,
    "ring1m": bench_ring1m,
    "forward": bench_forward_qps,
    "forward_comparator": bench_forward_comparator,
    "forward_ab": bench_forward_ab,
    "serve_ring": bench_serve_ring,
    "serve_fanin": bench_serve_fanin,
    "mc_churn": bench_mc_churn,
    "mc_chaos": bench_mc_chaos,
    "fleet_scale": bench_fleet_scale,
    "partition_lc": bench_partition_lifecycle,
    "sharded100k": bench_sharded100k,
    "delta16m": bench_delta16m,
    "multihost16m": bench_multihost16m,
    "dcn_wire": bench_dcn_wire,
    "swing_overlap": bench_swing_overlap,
    "churn100k": bench_churn100k,
    "flap1k": bench_flap1k,
    "asym_partition": bench_asym_partition,
    "topo_chaos": bench_topo_chaos,
    "gameday": bench_gameday,
}


def run_rows(names, seed: int, full: bool, platform: str) -> list:
    """Each row of ``names`` in turn, as ``main`` runs them: a row's
    exception becomes ``{"ok": false, "error": ...}`` and the next row runs
    (the JAX CLI's semantics; a caller that needs every row must treat such
    a record as a failure); ``bench``, ``platform``, ``full_scale`` and
    ``wall_s`` are set on every record."""
    results = []
    for name in names:
        t0 = time.perf_counter()
        try:
            result = BENCHES[name](seed, full)
        except Exception as e:  # a dying device mid-row must not take the remaining rows
            result = {"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}
        result.setdefault("bench", name)
        result["platform"] = platform
        result["full_scale"] = full
        result["wall_s"] = round(time.perf_counter() - t0, 2)
        _emit(result)
        results.append(result)
    return results


def main(argv=None) -> int:
    global _DEVICE, _TELEMETRY_PATH

    p = argparse.ArgumentParser(prog="simbench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--only", choices=sorted(BENCHES), default=None)
    p.add_argument("--full", action="store_true", help="full BASELINE sizes even on the CPU")
    p.add_argument("--cpu", action="store_true", help="run on the host (the plain PyTorch path)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write all scenario results to this JSON file")
    p.add_argument(
        "--telemetry", metavar="OUT.jsonl", default=None,
        help="write the sim-plane run journal (JSONL; one header per scenario + one record per fetched "
        "tick-block) for the engine-driving scenarios",
    )
    args = p.parse_args(argv)

    if args.cpu:
        platform, _DEVICE = "cpu", torch.device("cpu")
    else:
        try:
            platform = _platform()
        except RuntimeError as e:
            print(f"simbench: {e}; pass --cpu to run the rows on the host", file=sys.stderr)
            return 2
        _DEVICE = torch.device("cuda")
    if args.telemetry:
        _TELEMETRY_PATH = args.telemetry
        open(args.telemetry, "w").close()  # truncate; scenarios append
    full = args.full or platform == "gpu"
    names = [args.only] if args.only else list(BENCHES)
    results = run_rows(names, args.seed, full, platform)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"platform": platform, "full_scale": full, "scenarios": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
