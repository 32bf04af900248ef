"""Spawned rank groups for the port's sharding tests: P·R processes on the
CPU, joined by ``torch.distributed`` over gloo, each holding one rank of a
(P, R) ``parallel.mesh.Mesh`` (R = 1 unless a group names its shape), or
of a (Bm, P, R) ``parallel.mesh.FleetMesh`` when the shape has three axes;
the fleet's process-sliced sweeps run as jobs of a group of P processes.

``multiprocessing``'s spawn re-imports the module that holds a worker's
function, so this module imports neither ``jax`` nor the JAX package: the
tests compute the JAX side in the parent and compare.  :func:`run_group`
starts one group for a list of jobs and returns rank 0's results; a group
that does not finish by its deadline is killed and fails its test instead
of the suite's time limit (each process group also times its collectives
out after 60 s).
"""

from __future__ import annotations

import hashlib
import queue
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

GROUP_DEADLINE_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(size: int, jobs: list, deadline_s: float = GROUP_DEADLINE_S, shape=None, every_rank: bool = False):
    """Run ``jobs`` (a list of (name, job function name, payload)) in one
    group of ``size`` spawned ranks on a mesh of ``shape``: (P, R) (default
    (size, 1)) or (Bm, P, R) (a fleet mesh); returns {name: rank 0's
    result}, or with ``every_rank`` the list of every rank's.  Raises
    RuntimeError with a rank's traceback when any job fails, and when the
    group misses its deadline."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(rank, size, port, jobs, results, shape), daemon=True)
             for rank in range(size)]
    for proc in procs:
        proc.start()
    got = {}
    try:
        for _ in range(size):
            rank, ok, out = results.get(timeout=deadline_s)
            if not ok:
                raise RuntimeError(f"rank {rank} of {size} failed:\n{out}")
            got[rank] = out
    except queue.Empty:
        raise RuntimeError(f"a group of {size} ranks missed its {deadline_s} s deadline") from None
    finally:
        for proc in procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
    return [got[r] for r in range(size)] if every_rank else got[0]


def _rank_main(rank: int, size: int, port: int, jobs: list, results, shape=None) -> None:
    torch.set_num_threads(1)
    try:
        from ringpop_tpu_torch.parallel import mesh as pmesh, multihost

        multihost.init_distributed(f"127.0.0.1:{port}", size, rank, transport="gloo", timeout_s=60)
        if shape is not None and len(shape) == 3:
            mesh = pmesh.make_fleet_mesh(shape=shape, device="cpu")
        else:
            mesh = pmesh.make_mesh(shape=shape, device="cpu")
        out = {name: JOBS[job](mesh, payload) for name, job, payload in jobs}
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


# -- jobs: each takes (mesh, payload) and returns picklable host values --------


def rolls(mesh, payload: dict) -> dict:
    """``shard_roll`` and ``shard_roll_pipelined`` of a global plane and an
    int vector, gathered whole, at every (h, shift) of the payload, with
    the sends of each leg."""
    from ringpop_tpu_torch.parallel import shift

    n = payload["n"]
    x = torch.as_tensor(payload["x"])
    v = torch.as_tensor(payload["v"])
    lrn, ride = torch.as_tensor(payload["learned"]), torch.as_tensor(payload["ride"])
    lo, hi = mesh.block(n)
    out = {}
    for h in payload["hs"]:
        for s in payload["shifts"]:
            shift.reset_stats()
            a, b = shift.shard_roll((x[lo:hi], v[lo:hi]), s, mesh, "node", h=h)
            sends = list(shift.leg_sends)
            shift.reset_stats()
            pa, resp = shift.shard_roll_pipelined(
                (x[lo:hi],), s, mesh, "node", carry=(lrn[lo:hi], ride[lo:hi]),
                leg2_of=lambda inb, l, r: (l | inb) & r, h=h)
            out[(h, s)] = {"x": mesh.gather_rows(a).numpy(), "v": mesh.gather_rows(b).numpy(),
                           "pipelined_x": mesh.gather_rows(pa).numpy(), "resp": mesh.gather_rows(resp).numpy(),
                           "sends": sends, "pipelined_sends": list(shift.leg_sends)}
    return out


def _faults(spec: dict, device):
    from ringpop_tpu_torch.sim import chaos, topology
    from ringpop_tpu_torch.sim.delta import DeltaFaults

    if spec.get("plan"):
        horizon = spec.get("horizon", spec["ticks"])
        build = topology.topo_scenario_plan if spec.get("builder") == "topo" else chaos.scenario_plan
        return build(spec["plan"], spec["n"], seed=spec["seed"], horizon=horizon, device=device)
    up = np.ones(spec["n"], bool)
    up[spec["down"]] = False
    return DeltaFaults(up=torch.as_tensor(up), drop_rate=torch.tensor(spec["drop"], dtype=torch.float32))


def engine_run(mesh, spec: dict) -> dict:
    """One sharded run of an engine: ``spec["ticks"]`` steps from
    ``init_state``, every leaf gathered whole (``partition.host_gather``),
    with its queries; the lifecycle runs also take the detect path from
    the start (blocks, verdict, leaves) under each ``learned_sharding``
    route and then the converge loop."""
    from ringpop_tpu_torch.parallel import partition
    from ringpop_tpu_torch.parallel.mesh import with_exchange_mesh
    from ringpop_tpu_torch.sim import delta, lifecycle, telemetry

    faults = _faults(spec, mesh.device)
    engine = delta if spec["engine"] == "delta" else lifecycle
    if spec["engine"] == "delta":
        params = delta.DeltaParams(n=spec["n"], k=spec["k"], rng=spec["rng"], exchange=spec["exchange"])
    else:
        params = lifecycle.LifecycleParams(n=spec["n"], k=spec["k"], rng=spec["rng"], exchange=spec["exchange"],
                                           suspect_ticks=spec["suspect_ticks"], heal_prob=spec["heal_prob"])
    params = with_exchange_mesh(params, mesh, h=spec.get("h"), pipelined=spec.get("pipelined"))
    state = engine.init_state(params, seed=spec["seed"], device=mesh.device)
    hashes = [leaf_hashes(state, mesh, engine)] if spec.get("every_tick") else None
    for _ in range(spec["ticks"]):
        state = engine.step(params, state, faults)
        if hashes is not None:
            hashes.append(leaf_hashes(state, mesh, engine))
    out = {"leaves": partition.host_gather(state, mesh), "digest": int(telemetry.tree_digest(state, mesh)),
           "tick_hashes": hashes}
    if spec["engine"] == "delta":
        out["converged"] = bool(delta.converged(state, faults, mesh))
        out["fraction"] = float(delta.converged_fraction(state, faults, mesh))
        if spec.get("loop"):
            state, ticks, done = delta.run_until_converged(params, state, faults, max_ticks=64, check_every=8)
            out["run"] = (ticks, bool(done), partition.host_gather(state, mesh))
        return out
    out["views"] = partition.host_gather(lifecycle.view_checksums(state, faults, mesh), mesh, spec=partition.P("node"))
    out["views_converged"] = bool(lifecycle.checksums_converged(state, faults, mesh))
    out["detected_now"] = bool(lifecycle.detection_complete(state, spec["down"], faults, mesh=mesh))
    if spec.get("detect"):
        subjects = torch.as_tensor(spec["down"])
        detect = {}
        for route, hint in (("none", None), ("node", partition.P("node", None)), ("replicated", partition.P())):
            sharding = None if hint is None else partition.NamedSharding(mesh, hint)
            s, blocks, done = lifecycle._run_until_detected_device(
                params, lifecycle.init_state(params, seed=spec["seed"], device=mesh.device), faults, subjects,
                min_status=lifecycle.FAULTY, block_ticks=8, max_blocks=8, learned_sharding=sharding)
            detect[route] = (int(blocks), bool(done), partition.host_gather(s, mesh))
        s, blocks, done = lifecycle._run_until_converged_device(params, s, faults, block_ticks=8, max_blocks=8)
        out["detect"] = detect
        out["converge"] = (int(blocks), bool(done), partition.host_gather(s, mesh))
    return out


def leaf_hashes(state, mesh, engine) -> list:
    """sha256 of every leaf of ``state`` (this rank's block) gathered
    whole, in the JAX package's dtypes (``engine.state_to_numpy``)."""
    from ringpop_tpu_torch.parallel import partition

    whole = type(state)(*(torch.from_numpy(np.ascontiguousarray(x)) for x in partition.host_gather(state, mesh)))
    return [hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest() for x in engine.state_to_numpy(whole)]


def telemetry_run(mesh, spec: dict) -> dict:
    """``LifecycleSim`` with a ``TelemetrySink`` (and ``journal_views``)
    bound to the mesh: ``spec["blocks"]`` runs of ``spec["block"]`` ticks,
    then ``run_until_detected`` over the down nodes when the spec has no
    plan; the sink's records and the final leaves."""
    from ringpop_tpu_torch.parallel import partition
    from ringpop_tpu_torch.sim import lifecycle, telemetry

    faults = _faults(spec, mesh.device)
    sink = telemetry.TelemetrySink()
    sim = lifecycle.LifecycleSim(spec["n"], k=spec["k"], seed=spec["seed"], rng=spec["rng"],
                                 suspect_ticks=spec["suspect_ticks"], exchange=spec["exchange"],
                                 heal_prob=spec["heal_prob"], telemetry=sink, telemetry_tiers=spec.get("tiers", False), journal_views=True,
                                 exchange_mesh=mesh)
    for _ in range(spec["blocks"]):
        sim.run(spec["block"], faults)
    detect = None if spec["plan"] else sim.run_until_detected(spec["down"], faults, check_every=8)
    return {"records": sink.records, "detect": detect, "fetched": sim.fetch_telemetry(faults),
            "leaves": partition.host_gather(sim.state, mesh)}


def tel_chaos(mesh, spec: dict) -> dict:
    """``chip_smoke.tel_chaos_run`` (simbench's chaos recipe with a
    ``TelemetrySink``) on the mesh: its records and verdict, and the final
    leaves gathered."""
    import chip_smoke
    from ringpop_tpu_torch.parallel import partition

    got, sim = chip_smoke.tel_chaos_run(mesh.device, _faults(spec, mesh.device), spec["n"], spec["k"],
                                        spec["scenario"], tiers=spec.get("tiers", False), mesh=mesh)
    return {**got, "leaves": partition.host_gather(sim.state, mesh)}


def axis_checks(mesh, payload: dict) -> dict:
    """The mesh's own shape and coordinates, ``make_multihost_mesh``'s,
    ``shard_put`` of a whole state against the engine's own block, and
    the ValueError an engine raises for a k that does not shard over the
    rumor axis."""
    from ringpop_tpu_torch.parallel import multihost, partition
    from ringpop_tpu_torch.parallel.mesh import with_exchange_mesh
    from ringpop_tpu_torch.sim import delta, lifecycle

    out = {"shape": mesh.shape, "coords": mesh.coords}
    multi = multihost.make_multihost_mesh(rumor_shards=mesh.shape["rumor"], device="cpu")
    out["multihost"] = (multi.shape, multi.coords)
    n, k = payload["n"], payload["k"]
    for engine, params in ((delta, delta.DeltaParams(n=n, k=k, rng="counter")),
                           (lifecycle, lifecycle.LifecycleParams(n=n, k=k, rng="counter"))):
        whole = engine.init_state(params, seed=3, device="cpu")
        own = engine.init_state(with_exchange_mesh(params, mesh), seed=3)
        placed = partition.shard_put(whole, mesh, n)
        out[engine.__name__] = all(torch.equal(a, b) for a, b in zip(placed, own))
        back = partition.host_gather(placed, mesh)
        out[engine.__name__ + "_gather"] = all(np.array_equal(a, b.numpy()) for a, b in zip(back, whole))
    errors = {}
    for name, call in (("delta", lambda: delta.init_state(
                            with_exchange_mesh(delta.DeltaParams(n=n, k=payload["bad_k"]), mesh), device="cpu")),
                       ("lifecycle", lambda: lifecycle.step(
                            with_exchange_mesh(lifecycle.LifecycleParams(n=n, k=payload["bad_k"]), mesh),
                            lifecycle.init_state(lifecycle.LifecycleParams(n=n, k=payload["bad_k"]), device="cpu")))):
        try:
            call()
            errors[name] = "no error"
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


def refusals(mesh, payload: dict) -> dict:
    """A rumor axis above 1 in a live group, refused before ROADMAP A12b's
    first half: ``make_mesh`` and ``make_multihost_mesh`` now build the
    mesh (shape and coordinates); what still raises (NotImplementedError)
    is reported by its message."""
    from ringpop_tpu_torch.parallel import mesh as pmesh, multihost

    out = {}
    for name, call in (("make_mesh", lambda: pmesh.make_mesh(shape=(mesh.size // 2, 2), device="cpu")),
                       ("make_multihost_mesh", lambda: multihost.make_multihost_mesh(rumor_shards=2, device="cpu"))):
        try:
            got = call()
            out[name] = (got.shape, got.coords)
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def sim_run(mesh, spec: dict) -> dict:
    """``DeltaSim``/``LifecycleSim`` bound to the mesh through their
    ``exchange_mesh`` argument: the wrappers' run loops on this rank's
    block."""
    from ringpop_tpu_torch.parallel import partition
    from ringpop_tpu_torch.sim import delta, lifecycle

    faults = _faults(spec, mesh.device)
    if spec["engine"] == "delta":
        records = []
        sim = delta.DeltaSim(spec["n"], spec["k"], seed=spec["seed"], rng=spec["rng"], exchange_mesh=mesh,
                             telemetry_sink=records.append)
        got = sim.run_until_converged(faults, max_ticks=64, journal_every=16)
        recs = [{k: (v.item() if isinstance(v, torch.Tensor) else v) for k, v in r.items()} for r in records]
        return {"result": got, "records": recs, "leaves": partition.host_gather(sim.state, mesh)}
    sim = lifecycle.LifecycleSim(spec["n"], k=spec["k"], seed=spec["seed"], rng=spec["rng"],
                                 suspect_ticks=spec["suspect_ticks"], exchange_mesh=mesh)
    got = sim.run_until_detected(spec["down"], faults, check_every=8)
    conv = sim.run_until_converged(faults, check_every=8)
    state = lifecycle.admit(sim.params, sim.state, spec["down"][0])
    return {"result": got, "converge": conv, "leaves": partition.host_gather(state, mesh)}


# -- the fleet: meshes, process-sliced sweeps, the checkpoint store ----------------


def fleet_grid(spec: dict):
    """The scenario grid of a fleet spec, built by the port on the CPU:
    (params, plan, meta, seeds, victims)."""
    from ringpop_tpu_torch.sim import lifecycle, scenarios

    params = lifecycle.LifecycleParams(n=spec["n"], k=spec["k"], suspect_ticks=spec["suspect_ticks"], rng="counter")
    plan, meta = scenarios.scenario_grid(spec["n"], victims=spec["victims"], doses=spec["doses"],
                                         losses=spec["losses"], churn_seed=spec["churn_seed"], device="cpu")
    return params, plan, meta, scenarios.grid_seeds(meta, spec["seed"]), spec["victims"]


def fleet_mc(mesh, spec: dict) -> dict:
    """A ``MonteCarlo`` on a fleet mesh of ``spec["shape"]`` (the group's
    own mesh when None): ``spec["ticks"]`` ticks and a fetch (every rank's
    records), then, with ``spec["detect"]``, a fresh fleet's
    ``run_until_detected``, its records and every final leaf (the whole
    fleet in the JAX dtypes); and the mesh's stats by axis."""
    from ringpop_tpu_torch.sim import lifecycle, montecarlo

    if spec.get("shape") is not None:
        mesh = montecarlo.make_fleet_mesh(spec["size"], spec["shape"], device="cpu")
    params, plan, _, seeds, victims = fleet_grid(spec)
    mc = montecarlo.MonteCarlo(params, seeds, telemetry=True, mesh=mesh)
    mesh.reset_stats()
    mc.advance(spec["ticks"], plan)
    out = {"coords": mesh.coords, "block": mc.block, "local": int(mc.local_blocks()[0].tick.shape[0]),
           "records": mc.fetch_telemetry(plan),
           "digests": mc.digests(), "axis_stats": {ax: dict(v) for ax, v in mesh.axis_stats.items()}}
    if spec.get("detect"):
        mc = montecarlo.MonteCarlo(params, seeds, telemetry=True, mesh=mesh)
        ticks, detected = mc.run_until_detected(victims, plan, max_ticks=spec["max_ticks"],
                                                check_every=spec["check_every"])
        out["detect"] = (ticks.tolist(), detected.tolist())
        out["detect_records"] = mc.fetch_telemetry(plan)
        out["leaves"] = [np.asarray(x) for x in lifecycle.state_to_numpy(mc.states)]
    return out


def _sweep_out(sweep) -> dict:
    return {"digests": sweep.digests(), "scores": sweep.scores(), "header": sweep.header_params()}


def fleet_sweep(mesh, spec: dict) -> dict:
    """This process's slice of a process-sliced ``FleetSweep``
    (``process_block`` of the grid over the group's processes): run to
    ``spec["save_at"]``, save to ``spec["path"]``, run to the horizon."""
    from ringpop_tpu_torch.parallel import multihost, partition
    from ringpop_tpu_torch.sim import chaos, scenarios

    params, plan, meta, seeds, _ = fleet_grid(spec)
    lo, hi = partition.process_block(len(meta), multihost.process_index(), multihost.process_count())
    sweep = scenarios.FleetSweep(params, chaos.slice_plan(plan, lo, hi), meta[lo:hi], seeds[lo:hi],
                                 horizon=spec["horizon"], journal_every=spec["journal_every"], scenario="fleet-test",
                                 global_b=len(meta), device="cpu")
    sweep.run(until_tick=spec["save_at"])
    sweep.save(spec["path"])
    return _sweep_out(sweep.run())


def fleet_restore(mesh, spec: dict) -> dict:
    """Restore ``spec["path"]`` at this group: as this process's slice
    (``spec["shape"]`` None) or onto a fleet mesh of ``spec["shape"]``
    over the whole grid; with ``spec["resave"]``, run to
    ``spec["resave_at"]`` and save there from this layout; run to the
    horizon."""
    from ringpop_tpu_torch.parallel import multihost, partition
    from ringpop_tpu_torch.sim import chaos, montecarlo, scenarios

    params, plan, meta, seeds, _ = fleet_grid(spec)
    kw = {"scenario": "fleet-test", "device": "cpu"}
    if spec.get("shape") is not None:
        fleet = montecarlo.make_fleet_mesh(spec["size"], spec["shape"], device="cpu")
        sweep = scenarios.FleetSweep.restore(spec["path"], params, plan, meta, seeds, mesh=fleet, **kw)
    else:
        lo, hi = partition.process_block(len(meta), multihost.process_index(), multihost.process_count())
        sweep = scenarios.FleetSweep.restore(spec["path"], params, chaos.slice_plan(plan, lo, hi), meta[lo:hi],
                                             seeds[lo:hi], global_b=len(meta), **kw)
    if spec.get("resave"):
        sweep.run(until_tick=spec["resave_at"])
        sweep.save(spec["resave"])
    return _sweep_out(sweep.run())


def state_store(mesh, spec: dict) -> dict:
    """A lifecycle state stepped on this (P, R) mesh and saved through
    ``save_state_orbax`` (each rank its blocks), then restored at (4, 1) on
    the same ranks: the restored block against the rank's block of the
    whole state gathered from the (P, R) run."""
    from ringpop_tpu_torch.parallel import mesh as pmesh, partition
    from ringpop_tpu_torch.sim import lifecycle, snapshot

    params = pmesh.with_exchange_mesh(lifecycle.LifecycleParams(
        n=spec["n"], k=spec["k"], rng="counter", suspect_ticks=spec["suspect_ticks"], heal_prob=spec["heal_prob"]),
        mesh)
    state = lifecycle.init_state(params, seed=spec["seed"])
    for _ in range(spec["ticks"]):
        state = lifecycle.step(params, state, _faults(spec, mesh.device))
    snapshot.save_state_orbax(spec["path"], state, mesh=mesh)
    whole = lifecycle.LifecycleState(*(torch.from_numpy(np.array(x)) for x in partition.host_gather(state, mesh)))
    rows = pmesh.make_mesh(shape=(mesh.size * mesh.rumor_size, 1), device="cpu")
    back = snapshot.load_state_orbax(spec["path"], whole, lifecycle.state_shardings(rows))
    want = partition.shard_put(whole, rows, spec["n"])
    return {"whole": [np.asarray(x) for x in lifecycle.state_to_numpy(whole)],
            "restored_equal": all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(back, want))}


JOBS = {"rolls": rolls, "engine_run": engine_run, "refusals": refusals, "sim_run": sim_run,
        "telemetry_run": telemetry_run, "tel_chaos": tel_chaos, "axis_checks": axis_checks, "fleet_mc": fleet_mc,
        "fleet_sweep": fleet_sweep, "fleet_restore": fleet_restore, "state_store": state_store}

__all__ = ["run_group", "free_port"]
