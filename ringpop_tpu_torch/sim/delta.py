"""Scalable delta-dissemination simulator: O(N·K) state for million-node
clusters.

Counterpart of ``ringpop_tpu/sim/delta.py``, bit for bit under both of its
streams: ``rng="threefry"`` (the default, the ``jax.random`` draws of
``sim/threefry``) and ``rng="counter"`` (``sim/prng``).  A SWIM view is
``converged base ⊔ set of applied changes``, and change application is a
lattice max, so a node's view is exactly determined by which of the K
in-flight changes it has learned.  The
cluster state is:

* ``learned[N, W]`` — which rumors each node has absorbed, bit-packed 32
  slots to an int32 word along the rumor axis (``sim/packbits``);
* ``pcount[N, K]`` — int8 piggyback counters with the SWIM maxP bound
  (``disseminator.go:75-97``);
* ``ride_ok[N, W]`` — the carried invariant ``pack_bool(pcount < max_p)``.

One tick: every node pings one peer (fault-masked), rumors ride both legs
of the exchange, counters bump, expired rumors stop riding, and a rumor
whose counters all expired short of full coverage is re-seeded (the
full-sync analog).  Convergence: every live node has learned every rumor.

On the card, the per-tick row reduces and the convergence test run the
Hopper kernels of ``csrc/packbits.cu`` (through ``sim/packbits``) and each
threefry draw the kernel of ``csrc/threefry.cu``; the rest of the tick is
plain PyTorch.  ``run_until_converged`` is a Python loop over
blocks of ``check_every`` ticks with one host sync per block.

``DeltaSim(telemetry_sink=...)`` journals one record a block (tick,
coverage, the state digest: ``telemetry.delta_record``).  Every engine
takes a time-varying ``chaos.FaultPlan`` where it takes a ``DeltaFaults``:
:func:`resolve_faults` evaluates any object with an ``at_tick`` method at
the state's tick.

Sharded over a (P, R) mesh (``params.exchange_mesh``, a
``parallel.mesh.Mesh`` of more than one rank): the state is this rank's
block (``partition.shard_put``): node rows block p, and word block r of
the packed planes (slot block r of ``pcount``); the faults stay whole on
every rank, and every [N] vector and draw of the tick is computed whole on
every rank.  Every step of the tick on a slot is that slot's own, so each
word block runs the tick by itself: the planes' cross-rank steps are the
shift exchange's two roll legs (``parallel/shift``) and the uniform
exchange's row gathers, over the node axis, and the row reduces' combines
(``packbits.*_across``), over the node axis too; only the queries combine
over the rumor axis.  The gathered result is the unsharded tick's, bit for
bit.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.parallel.shift import shard_roll
from ringpop_tpu_torch.sim import prng, threefry
from ringpop_tpu_torch.sim.packbits import (
    and_reduce_rows,
    and_reduce_rows_across,
    check_rumor_shardable,
    n_words,
    or_reduce_rows_across,
    pack_bool,
    popcount_rows,
    popcount_rows_across,
    row_mask,
    unpack_bits,
)


class DeltaState(NamedTuple):
    learned: torch.Tensor  # int32[N, W] holding uint32 words, W = ceil(K/32)
    pcount: torch.Tensor  # int8[N, K]
    ride_ok: torch.Tensor  # int32[N, W]: pack_bool(pcount < clamped_max_p), carried
    tick: torch.Tensor  # int32 scalar
    key: torch.Tensor  # int64[2] holding the uint32 PRNG key


# int8 piggyback counters can take a sender + receiver bump (+2) in one tick
# from max_p-1, so the usable cap is 126, not 127 — shared by every engine
INT8_SAFE_MAX_P = 126

# -- topology tiers: rack within zone within region ----------------------------
TIER_LEVELS = 3
N_TIERS = TIER_LEVELS + 1
TIER_NAMES = ("same-rack", "cross-rack", "cross-zone", "cross-region")

# the profiler ranges of ``step``, in order (the JAX package's phase scopes,
# with its full-sync repair split out of "piggyback-counters")
PHASES = ("ping-target", "rumor-exchange", "piggyback-counters", "full-sync")


def resolve_max_p(n: int, p_factor: int, max_p: Optional[int]) -> int:
    """SWIM dissemination bound maxP = pFactor·⌈log10(n+1)⌉ unless overridden
    (parity: ``disseminator.go:75-97``)."""
    if max_p is not None:
        return max_p
    return int(p_factor * np.ceil(np.log10(n + 1)))


def clamped_max_p(params) -> int:
    """The int8-safe piggyback cap every engine compares counters against
    (one definition: the carried ``ride_ok`` invariant depends on it)."""
    return min(params.resolved_max_p(), INT8_SAFE_MAX_P)


@dataclass(frozen=True)
class DeltaParams:
    n: int
    k: int  # change-table capacity (rumors in flight)
    p_factor: int = 15  # disseminator.go:35
    max_p: Optional[int] = None  # override; default pFactor*ceil(log10(n+1))
    # ping-partner topology per tick: "shift" — targets[i] = (i + s) % n with
    # a fresh random shift s each tick (every node pings and is pinged once);
    # "uniform" — an independent uniform target per node (collisions merge)
    exchange: str = "shift"
    # PRNG family: "threefry" = the jax.random draws (sim/threefry.py) the
    # frozen goldens pin; "counter" = the stateless stream of sim/prng.py
    rng: str = "threefry"
    # a parallel.mesh.Mesh of (P, R) ranks: the engine then takes and returns
    # this rank's block (parallel/mesh.with_exchange_mesh)
    exchange_mesh: Optional[Any] = None
    # the shift legs' sub-block factor H (H + 1 sends a rolled leaf a leg,
    # parallel/shift), read only with a mesh; exchange_pipelined is the JAX
    # package's switch between its fused and sequential leg regions, kept
    # for its params: the port's legs are the same two shard_roll calls
    # either way, so it is not read
    exchange_h: int = 2
    exchange_pipelined: bool = True

    def resolved_max_p(self) -> int:
        return resolve_max_p(self.n, self.p_factor, self.max_p)


@dataclass(frozen=True)
class DeltaFaults:
    """The per-tick fault model of the O(N·K) engines; every leg is
    optional and a None leg costs nothing.

    * ``up`` — process liveness, bool[N].
    * ``group``/``reach`` — partition groups int32[N] (-1 = unpartitioned);
      without ``reach`` the partition is symmetric, with ``reach[G, G]``
      the (a → b) exchange is delivered iff ``reach[group[a], group[b]]``.
    * ``drop_rate`` — scalar per-leg loss probability (float32).
    * ``drop_node`` — float32[N] per-node loss: a leg survives with
      probability ``(1-drop_node[a])·(1-drop_node[b])·(1-drop_rate)``.
    * ``tier_ids``/``tier_drop`` — int32[3, N] rack/zone/region ids and a
      float32[4] loss table indexed by the leg's tier distance.
    * ``suspect_ticks`` — the lifecycle engine's timeout override; the
      delta engine does not read it.
    """

    up: Optional[torch.Tensor] = None
    group: Optional[torch.Tensor] = None
    drop_rate: Optional[Any] = None
    drop_node: Optional[torch.Tensor] = None
    reach: Optional[torch.Tensor] = None
    tier_ids: Optional[torch.Tensor] = None
    tier_drop: Optional[torch.Tensor] = None
    suspect_ticks: Optional[torch.Tensor] = None


def resolve_faults(faults, tick):
    """A time-varying fault plan (any object with an ``at_tick`` method) is
    evaluated at ``tick``; a plain fault model passes through untouched."""
    at = getattr(faults, "at_tick", None)
    return faults if at is None else at(tick)


def pair_connected(faults: DeltaFaults, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Static (loss-free) connectivity of the (a → b) exchange between node
    index tensors ``a`` and ``b``: both processes up and the partition
    (symmetric groups, or the directed ``reach`` matrix) lets a's group
    send to b's."""
    ok = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    if faults.up is not None:
        ok &= faults.up[a] & faults.up[b]
    if faults.group is not None:
        g = faults.group
        ga, gb = g[a], g[b]
        reach = getattr(faults, "reach", None)
        if reach is not None:
            r = reach[ga.clamp_min(0).long(), gb.clamp_min(0).long()]
            ok &= (ga < 0) | (gb < 0) | r
        else:
            ok &= (ga < 0) | (gb < 0) | (ga == gb)
    return ok


def has_drop(faults: DeltaFaults) -> bool:
    """Does this fault model lose messages at all?"""
    return faults.drop_rate is not None or faults.drop_node is not None


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def leg_survives(faults: DeltaFaults, u: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bool mask: the (a → b) leg survives packet loss, given uniform draws
    ``u`` shaped like ``a``/``b``.  The float32 products are taken in the
    JAX package's order: ``((1-dn[a]) * (1-dn[b])) * (1-drop_rate)``."""
    if faults.drop_node is None:
        return u >= _f32(faults.drop_rate, u.device)
    dn = faults.drop_node
    keep = (1.0 - dn[a]) * (1.0 - dn[b])
    if faults.drop_rate is not None:
        keep = keep * (1.0 - _f32(faults.drop_rate, u.device))
    return u < keep


# -- topology tier evaluation -------------------------------------------------


def check_tier_legs(faults: DeltaFaults) -> bool:
    """The topology legs come as a pair (a topology) or not at all."""
    has_ids = getattr(faults, "tier_ids", None) is not None
    has_drop_t = getattr(faults, "tier_drop", None) is not None
    if has_ids != has_drop_t:
        raise ValueError(
            "topology legs come as a pair: tier_ids (int32[3, N]) and "
            "tier_drop (float32[4]) — one without the other is a "
            "construction error (sim/topology.py compiles both)"
        )
    return has_ids


def tier_pair(faults: DeltaFaults, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 tier distance of the (a → b) leg: the number of hierarchy
    levels whose ids differ (0 same-rack … 3 cross-region)."""
    ids = faults.tier_ids
    da = ids[..., a]  # [TIER_LEVELS, *a.shape]
    db = ids[..., b]
    return (da != db).sum(dim=0, dtype=torch.int32)


def tier_pair_drop(faults: DeltaFaults, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 per-leg loss probability from the per-tier table: the sum of
    ``(tier == t) · table[t]`` over the tiers, in the JAX package's order."""
    t = tier_pair(faults, a, b)
    table = _f32(faults.tier_drop, t.device)
    drop = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    for ti in range(N_TIERS):
        drop = drop + torch.where(t == ti, table[..., ti], 0.0)
    return drop


def sharding_of(params):
    """The mesh the engine shards over: ``params.exchange_mesh`` when it
    has more than one rank (its node blocks must divide n, and k must
    shard over its rumor axis: ``packbits.check_rumor_shardable``), else
    None."""
    mesh = params.exchange_mesh
    if mesh is None or not mesh.sharded:
        return None
    mesh.block(params.n)  # ValueError when the ranks do not divide n
    check_rumor_shardable(params.k, mesh.shape["rumor"])
    return mesh


def rumor_block(mesh, k: int) -> tuple[slice, slice]:
    """(slots, words): this rank's block of the rumor axis of a k-slot
    table, the whole axis with ``mesh`` None or one rumor rank."""
    if mesh is None or mesh.shape["rumor"] == 1:
        return slice(0, k), slice(0, n_words(k))
    s0, s1 = mesh.col_block(k)
    return slice(s0, s1), slice(s0 // 32, s1 // 32)


def node_mesh(mesh):
    """``mesh`` when its node axis has more than one rank (the planes'
    rows are then a block and the rolls cross ranks), else None."""
    return mesh if mesh is not None and mesh.shape["node"] > 1 else None


def whole_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """A node-sharded leaf whole: ``x`` itself, or under a mesh every
    rank's block gathered."""
    return x if mesh is None else mesh.gather_rows(x)


def init_state(
    params: DeltaParams, seed: int = 0, sources: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> DeltaState:
    """K rumors, each initially known only to its source node (default:
    rumor j starts at node j mod N).  ``key`` is ``prng.prng_key(seed)``,
    the value ``jax.random.PRNGKey(seed)`` has.  Under a mesh
    (:func:`sharding_of`), this rank's block (its rows, and its word and
    slot block), on the mesh's device unless ``device`` is given."""
    mesh = sharding_of(params)
    dev = resolve_device(params.exchange_mesh.device if params.exchange_mesh is not None and device is None
                         else device)
    n, k = params.n, params.k
    lo, hi = mesh.block(n) if mesh is not None else (0, n)
    if sources is None:
        sources = np.arange(k, dtype=np.int64) % n
    rows, cols = np.asarray(sources, np.int64), np.arange(k)
    if mesh is not None:  # the sources this rank's rows hold
        own = (rows >= lo) & (rows < hi)
        rows, cols = rows[own] - lo, cols[own]
    learned_b = torch.zeros((hi - lo, k), dtype=torch.bool, device=dev)
    learned_b[torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)] = True
    slots, words = rumor_block(mesh, k)
    kl = slots.stop - slots.start
    return DeltaState(
        learned=pack_bool(learned_b)[:, words].contiguous(),
        pcount=torch.zeros((hi - lo, kl), dtype=torch.int8, device=dev),
        ride_ok=pack_bool(torch.zeros((hi - lo, kl), dtype=torch.int8, device=dev) < clamped_max_p(params)),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
        key=prng.prng_key(seed, dev),
    )


def _check_supported(params: DeltaParams) -> None:
    if params.rng not in ("threefry", "counter"):
        raise ValueError(f"unknown rng family {params.rng!r}")
    sharding_of(params)


def step(params: DeltaParams, state: DeltaState, faults: DeltaFaults = DeltaFaults()) -> DeltaState:
    """One protocol period for all N nodes, bit-equal to the JAX package's
    ``step`` under either stream.  ``faults`` may be a ``DeltaFaults`` or a
    plan with ``at_tick`` (evaluated at ``state.tick``).  The profiler
    ranges name the protocol phases as the JAX package's scopes do."""
    _check_supported(params)
    faults = resolve_faults(faults, state.tick)
    n, k = params.n, params.k
    dev = state.learned.device
    max_p = clamped_max_p(params)
    shift_mode = params.exchange == "shift"
    use_counter = params.rng == "counter"
    # under a mesh the planes are this rank's rows [lo, hi) and its kl
    # slots' words; every [N] vector below is whole, and ``loc`` cuts this
    # rank's rows out of one.  Every plane step is per slot, so the word
    # block runs the tick on its own: the cross-rank steps are over the
    # node axis (``rolls``: the roll legs, None with one node rank)
    mesh = sharding_of(params)
    rolls = node_mesh(mesh)
    lo, hi = mesh.block(n) if mesh is not None else (0, n)
    loc = slice(lo, hi)
    slots, _ = rumor_block(mesh, k)
    kl = slots.stop - slots.start

    with record_function("ping-target"):
        if use_counter:
            # stateless counter stream: the key leaf carries the seed
            # material unchanged and the tick counter advances the stream
            key = state.key
            cseed = prng.fold_key(state.key)
            ctick = state.tick
        else:
            key, k_target, k_drop = threefry.split(state.key, 3)
        i_all = torch.arange(n, dtype=torch.int64, device=dev)
        if shift_mode:
            # the shift stays on the device: index vectors, no roll by a host int
            s = (prng.draw_randint(cseed, ctick, prng.D_SHIFT, 0, 1, n) if use_counter
                 else threefry.randint(k_target, (), 1, n)).to(torch.int64)
            targets = (i_all + s) % n
        else:
            targets = (prng.draw_randint(cseed, ctick, prng.D_TARGET, i_all, 0, n - 1) if use_counter
                       else threefry.randint(k_target, (n,), 0, n - 1)).to(torch.int64)
            targets = torch.where(targets >= i_all, targets + 1, targets)

        up = faults.up
        conn = pair_connected(faults, i_all, targets)
        if has_drop(faults):
            drop_u = (prng.draw_uniform(cseed, ctick, prng.D_DROP, i_all) if use_counter
                      else threefry.uniform(k_drop, (n,)))
            conn &= leg_survives(faults, drop_u, i_all, targets)
        if check_tier_legs(faults):
            if not use_counter:
                raise ValueError(
                    "topology tier legs need rng='counter': their loss coin is an "
                    "extra stateless draw site; under threefry the extra split would "
                    "shift every other draw"
                )
            # a separate stateless coin per leg: an all-zero table passes every draw
            topo_u = prng.draw_uniform(cseed, ctick, prng.D_TOPO, i_all)
            conn &= topo_u >= tier_pair_drop(faults, i_all, targets)

    with record_function("rumor-exchange"):
        if shift_mode:
            ride_ok_w = state.ride_ok
            cmask = row_mask(conn)[loc]
            riding_w = state.learned & ride_ok_w
            # request leg: sender i's rumors land at targets[i]; node j is
            # pinged only by j - s, so delivery is a row gather.  torch's %
            # takes the divisor's sign (jnp.mod), so (i - s) % n is in [0, n)
            sent_w = riding_w & cmask
            idx_fwd = (i_all - s) % n
            got_pinged = conn.index_select(0, idx_fwd)[loc]
            if rolls is None:
                inbound_w = sent_w.index_select(0, idx_fwd)
            else:
                # the shift legs over the ranks' blocks (parallel/shift): the
                # shift picks their send plan on the host, one sync a tick
                s_host = int(s)
                (inbound_w,) = shard_roll((sent_w,), s_host, rolls, "node", h=params.exchange_h)
            learned1_w = state.learned | inbound_w
            # response leg: the target's riding rumors come back to the pinger
            answerable_w = learned1_w & ride_ok_w
            if rolls is None:
                resp_src = answerable_w.index_select(0, (i_all + s) % n)
            else:
                (resp_src,) = shard_roll((answerable_w,), n - s_host, rolls, "node", h=params.exchange_h)
            learned2_w = learned1_w | (resp_src & cmask)
        else:
            # the scatter by target reads every row: under a mesh the packed
            # planes' rows are gathered whole over the node axis (the gate
            # from the carried ride_ok, which is pack_bool(pcount < max_p)
            # by construction)
            learned0_b = unpack_bits(whole_rows(state.learned, mesh), kl)
            ride_ok_b = (state.pcount < max_p if mesh is None
                         else unpack_bits(mesh.gather_rows(state.ride_ok), kl))
            riding_b = learned0_b & ride_ok_b
            sent_b = riding_b & conn[:, None]
            # scatter-or by target: a max over duplicate targets on a zero plane
            inbound_b = torch.zeros((n, kl), dtype=torch.uint8, device=dev).scatter_reduce_(
                0, targets[:, None].expand(n, kl), sent_b.to(torch.uint8), "amax", include_self=True
            ).to(torch.bool)
            got_pinged = torch.zeros(n, dtype=torch.uint8, device=dev).scatter_reduce_(
                0, targets, conn.to(torch.uint8), "amax", include_self=True
            ).to(torch.bool)
            learned1_b = learned0_b | inbound_b
            answerable_b = learned1_b & ride_ok_b
            resp_b = answerable_b[targets] & conn[:, None]
            learned2_b = (learned1_b | resp_b)[loc]
            learned2_w = pack_bool(learned2_b)

    with record_function("piggyback-counters"):
        if shift_mode:
            # bump = sent + (riding & got_pinged) = riding * (conn + got)
            riding_bit = unpack_bits(riding_w, kl)
            bump = riding_bit.to(torch.int8) * (conn[loc].to(torch.int8) + got_pinged.to(torch.int8))[:, None]
            newly_bit = unpack_bits(learned2_w & ~state.learned, kl)
        else:
            bump = (sent_b.to(torch.int8) + (riding_b & got_pinged[:, None]).to(torch.int8))[loc]
            newly_bit = learned2_b & ~learned0_b[loc]

        # sender bumps on success, receiver once per busy tick; newly learned
        # rumors start at 0.  A bump lands only where pcount < max_p <= 126,
        # so the int8 sum stays <= 127
        pcount_mid = (state.pcount + bump).clamp_max(max_p).masked_fill(newly_bit, 0)

    with record_function("full-sync"):
        # a rumor whose counters all expired short of full coverage is
        # re-seeded.  The two row reduces read the up mask directly instead
        # of a masked copy of the plane
        mid_ride_w = pack_bool(pcount_mid < max_p)
        up_loc = None if up is None else up[loc]
        fully_w = and_reduce_rows_across(learned2_w, up_loc, mesh)
        live_riding_w = or_reduce_rows_across(learned2_w & mid_ride_w, up_loc, mesh)
        fully = unpack_bits(fully_w, kl)
        stuck = ~unpack_bits(live_riding_w, kl) & ~fully
        reset_w = learned2_w & pack_bool(stuck)[None, :]
        pcount = pcount_mid.masked_fill(unpack_bits(reset_w, kl), 0)
        # the carried invariant: riding resumes where the reset re-opened
        # counters, plus wherever the mid gate was already open
        ride_ok_next = mid_ride_w | reset_w

    return DeltaState(
        learned=learned2_w, pcount=pcount, ride_ok=ride_ok_next, tick=state.tick + 1, key=key
    )


def converged_fraction(state: DeltaState, faults: DeltaFaults = DeltaFaults(), mesh=None) -> torch.Tensor:
    """Fraction of (live node, rumor) pairs delivered, float32 0-d: per-row
    popcounts (exact in float32) summed in float32.  The sum's order is not
    the JAX package's, so the two agree to ~1e-7 relative, not bit for bit.
    With a ``mesh`` (``state`` this rank's block), the per-row counts of the
    word blocks are added over the rumor axis, gathered over the node axis
    and summed whole on every rank: the unsharded port's value, bit for
    bit."""
    faults = resolve_faults(faults, state.tick)
    sharded = mesh is not None and mesh.sharded
    k = state.pcount.shape[1] * (mesh.shape["rumor"] if sharded else 1)
    bits = (popcount_rows_across(state.learned, mesh) if sharded else popcount_rows(state.learned)).to(torch.float32)
    n = bits.shape[0]
    if faults.up is not None:
        live = faults.up
        denom = live.sum(dtype=torch.float32).clamp_min(1.0) * k
        return torch.where(live, bits, 0.0).sum() / denom
    return bits.sum() / (n * k)


def converged(state: DeltaState, faults: DeltaFaults = DeltaFaults(), mesh=None) -> torch.Tensor:
    """bool 0-d tensor on the state's device: have all rumors reached every
    live node?  (Dead rows are vacuously done.)  With a ``mesh``, ``state``
    is this rank's block: the AND spans the node axis, and the word blocks'
    answers are ANDed over the rumor axis."""
    faults = resolve_faults(faults, state.tick)
    k = state.pcount.shape[1]
    if mesh is None or not mesh.sharded:
        return unpack_bits(and_reduce_rows(state.learned, faults.up), k).all()
    lo, hi = mesh.block(state.learned.shape[0] * mesh.size)
    up = None if faults.up is None else faults.up[lo:hi]
    done = unpack_bits(and_reduce_rows_across(state.learned, up, mesh), k).all()
    return mesh.all_gather(done, "rumor").all() if mesh.shape["rumor"] > 1 else done


def until_loop(run_block, state, max_blocks: int, pred):
    """Blocks of ``run_block(state) -> state`` until ``pred(state)`` (a bool
    0-d tensor) holds or ``max_blocks`` blocks ran: the predicate is tested
    on entry and after each block, and its ``bool`` is the one host sync
    per block.  An already satisfied predicate reports 0 blocks.  Returns
    (state, blocks, done)."""
    blocks = 0
    done = bool(pred(state))
    while not done and blocks < max_blocks:
        state = run_block(state)
        blocks += 1
        done = bool(pred(state))
    return state, blocks, done


def run_until_converged(
    params: DeltaParams,
    state: DeltaState,
    faults: DeltaFaults = DeltaFaults(),
    max_ticks: int = 10_000,
    check_every: int = 8,
):
    """Run blocks of ``check_every`` ticks until all rumors reach all live
    nodes, testing on the device on entry and after each block
    (:func:`until_loop`).  Returns (state, ticks_used, converged)."""
    _check_supported(params)

    def run_block(s):
        for _ in range(check_every):
            s = step(params, s, faults)
        return s

    mesh = sharding_of(params)
    state, blocks, done = until_loop(
        run_block, state, -(-max_ticks // check_every), lambda s: converged(s, faults, mesh)
    )
    return state, blocks * check_every, done


class DeltaSim:
    """Host-side convenience wrapper: params, state on ``device`` (the card
    unless the caller asks for the CPU), ``tick`` and
    ``run_until_converged``.  ``telemetry_sink`` (any callable taking a
    record dict, e.g. a ``telemetry.TelemetrySink``) turns on the run
    journal: ``run_until_converged`` then runs in ``journal_every``-tick
    blocks and hands over one ``telemetry.delta_record`` a block; with no
    sink it runs exactly the journal-free loop.  With ``exchange_mesh`` (a
    (P, R) mesh) the state is this rank's block, on the mesh's
    device unless ``device`` is given, and every rank must call each
    method in step with the others."""

    def __init__(self, n: int, k: int, seed: int = 0, telemetry_sink=None,
                 device: DeviceLike = None, **kw):
        self.params = DeltaParams(n=n, k=k, **kw)
        self.state = init_state(self.params, seed=seed, device=device)
        self.telemetry_sink = telemetry_sink

    def tick(self, faults: DeltaFaults = DeltaFaults()) -> DeltaState:
        self.state = step(self.params, self.state, faults)
        return self.state

    def run_until_converged(self, faults: DeltaFaults = DeltaFaults(), max_ticks: int = 10_000,
                            journal_every: int = 64):
        if self.telemetry_sink is None:
            self.state, ticks, ok = run_until_converged(
                self.params, self.state, faults, max_ticks=max_ticks
            )
            return ticks, ok
        from ringpop_tpu_torch.sim.telemetry import delta_record

        ticks, ok = 0, False
        while ticks < max_ticks and not ok:
            block = min(journal_every, max_ticks - ticks)
            self.state, t, ok = run_until_converged(self.params, self.state, faults, max_ticks=block)
            ticks += t
            self.telemetry_sink(delta_record(self.state, faults, sharding_of(self.params)))
            if t == 0 and not ok:  # budget too small for one check block
                break
        return ticks, ok


# -- carrying a JAX state across ------------------------------------------------

_LEAF_DTYPES = {  # leaf -> (JAX numpy dtype, port torch dtype)
    "learned": (np.uint32, torch.int32),
    "pcount": (np.int8, torch.int8),
    "ride_ok": (np.uint32, torch.int32),
    "tick": (np.int32, torch.int32),
    "key": (np.uint32, torch.int64),
}


def state_from_numpy(leaves, device: DeviceLike = None) -> DeltaState:
    """A ``DeltaState`` on ``device`` from the JAX package's leaves (a JAX
    ``DeltaState`` or any sequence in its field order, as numpy-convertible
    arrays): uint32 planes cross as their int32 bit pattern, the key as
    int64."""
    dev = resolve_device(device)
    out = []
    for name, leaf in zip(DeltaState._fields, leaves):
        np_dtype, dtype = _LEAF_DTYPES[name]
        arr = np.asarray(leaf).astype(np_dtype, copy=False)
        arr = arr.view(np.int32) if dtype == torch.int32 and np_dtype == np.uint32 else (
            arr.astype(np.int64) if dtype == torch.int64 else arr)
        out.append(torch.as_tensor(np.array(arr), device=dev))
    return DeltaState(*out)


def state_to_numpy(state: DeltaState) -> DeltaState:
    """The leaves as numpy arrays of the JAX package's dtypes (uint32
    planes and key, int8 pcount, int32 tick)."""
    out = []
    for name, leaf in zip(DeltaState._fields, state):
        np_dtype, _ = _LEAF_DTYPES[name]
        arr = leaf.detach().cpu().numpy()
        out.append(arr.view(np_dtype) if arr.dtype.itemsize == np.dtype(np_dtype).itemsize
                   else arr.astype(np_dtype))
    return DeltaState(*out)


_FAULT_DTYPES = {
    "up": torch.bool, "group": torch.int32, "drop_rate": torch.float32,
    "drop_node": torch.float32, "reach": torch.bool, "tier_ids": torch.int32,
    "tier_drop": torch.float32, "suspect_ticks": torch.int32,
}


def faults_from_numpy(faults, device: DeviceLike = None) -> DeltaFaults:
    """A ``DeltaFaults`` on ``device`` from the JAX package's (any object
    with its field names; missing or None legs stay None)."""
    dev = resolve_device(device)
    legs = {}
    for f in fields(DeltaFaults):
        leaf = getattr(faults, f.name, None)
        if leaf is not None:
            legs[f.name] = torch.as_tensor(np.array(leaf), device=dev).to(_FAULT_DTYPES[f.name])
    return DeltaFaults(**legs)
