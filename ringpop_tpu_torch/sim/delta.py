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

Not ported yet, each refused with NotImplementedError: the sharded
exchange (``exchange_mesh``, ROADMAP A12) and
``DeltaSim(telemetry_sink=...)`` (A7).  There is no ``FaultPlan`` in the
port yet; :func:`resolve_faults` passes through any object with an
``at_tick`` method.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.sim import prng, threefry
from ringpop_tpu_torch.sim.packbits import (
    and_reduce_rows,
    or_reduce_rows,
    pack_bool,
    popcount_rows,
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
    # the sharded exchange of the JAX package, refused until ROADMAP A12
    # (its exchange_h / exchange_pipelined tuning fields come with it)
    exchange_mesh: Optional[Any] = None

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


def init_state(
    params: DeltaParams, seed: int = 0, sources: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> DeltaState:
    """K rumors, each initially known only to its source node (default:
    rumor j starts at node j mod N).  ``key`` is ``prng.prng_key(seed)``,
    the value ``jax.random.PRNGKey(seed)`` has."""
    dev = resolve_device(device)
    n, k = params.n, params.k
    if sources is None:
        sources = np.arange(k, dtype=np.int64) % n
    learned_b = torch.zeros((n, k), dtype=torch.bool, device=dev)
    learned_b[torch.as_tensor(np.asarray(sources, np.int64), device=dev),
              torch.arange(k, device=dev)] = True
    return DeltaState(
        learned=pack_bool(learned_b),
        pcount=torch.zeros((n, k), dtype=torch.int8, device=dev),
        ride_ok=pack_bool(torch.zeros((n, k), dtype=torch.int8, device=dev) < clamped_max_p(params)),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
        key=prng.prng_key(seed, dev),
    )


def _check_supported(params: DeltaParams) -> None:
    if params.rng not in ("threefry", "counter"):
        raise ValueError(f"unknown rng family {params.rng!r}")
    if params.exchange_mesh is not None:
        raise NotImplementedError(
            "exchange_mesh (the sharded shift exchange) is not ported yet "
            "(ROADMAP Queue A12)"
        )


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
            cmask = row_mask(conn)
            riding_w = state.learned & ride_ok_w
            # request leg: sender i's rumors land at targets[i]; node j is
            # pinged only by j - s, so delivery is a row gather.  torch's %
            # takes the divisor's sign (jnp.mod), so (i - s) % n is in [0, n)
            sent_w = riding_w & cmask
            idx_fwd = (i_all - s) % n
            inbound_w = sent_w.index_select(0, idx_fwd)
            got_pinged = conn.index_select(0, idx_fwd)
            learned1_w = state.learned | inbound_w
            # response leg: the target's riding rumors come back to the pinger
            answerable_w = learned1_w & ride_ok_w
            resp_src = answerable_w.index_select(0, (i_all + s) % n)
            learned2_w = learned1_w | (resp_src & cmask)
        else:
            learned0_b = unpack_bits(state.learned, k)
            ride_ok_b = state.pcount < max_p
            riding_b = learned0_b & ride_ok_b
            sent_b = riding_b & conn[:, None]
            # scatter-or by target: a max over duplicate targets on a zero plane
            inbound_b = torch.zeros((n, k), dtype=torch.uint8, device=dev).scatter_reduce_(
                0, targets[:, None].expand(n, k), sent_b.to(torch.uint8), "amax", include_self=True
            ).to(torch.bool)
            got_pinged = torch.zeros(n, dtype=torch.uint8, device=dev).scatter_reduce_(
                0, targets, conn.to(torch.uint8), "amax", include_self=True
            ).to(torch.bool)
            learned1_b = learned0_b | inbound_b
            answerable_b = learned1_b & ride_ok_b
            resp_b = answerable_b[targets] & conn[:, None]
            learned2_b = learned1_b | resp_b
            learned2_w = pack_bool(learned2_b)

    with record_function("piggyback-counters"):
        if shift_mode:
            # bump = sent + (riding & got_pinged) = riding * (conn + got)
            riding_bit = unpack_bits(riding_w, k)
            bump = riding_bit.to(torch.int8) * (conn.to(torch.int8) + got_pinged.to(torch.int8))[:, None]
            newly_bit = unpack_bits(learned2_w & ~state.learned, k)
        else:
            bump = sent_b.to(torch.int8) + (riding_b & got_pinged[:, None]).to(torch.int8)
            newly_bit = learned2_b & ~learned0_b

        # sender bumps on success, receiver once per busy tick; newly learned
        # rumors start at 0.  A bump lands only where pcount < max_p <= 126,
        # so the int8 sum stays <= 127
        pcount_mid = (state.pcount + bump).clamp_max(max_p).masked_fill(newly_bit, 0)

    with record_function("full-sync"):
        # a rumor whose counters all expired short of full coverage is
        # re-seeded.  The two row reduces read the up mask directly instead
        # of a masked copy of the plane
        mid_ride_w = pack_bool(pcount_mid < max_p)
        fully = unpack_bits(and_reduce_rows(learned2_w, up), k)
        stuck = ~unpack_bits(or_reduce_rows(learned2_w & mid_ride_w, up), k) & ~fully
        reset_w = learned2_w & pack_bool(stuck)[None, :]
        pcount = pcount_mid.masked_fill(unpack_bits(reset_w, k), 0)
        # the carried invariant: riding resumes where the reset re-opened
        # counters, plus wherever the mid gate was already open
        ride_ok_next = mid_ride_w | reset_w

    return DeltaState(
        learned=learned2_w, pcount=pcount, ride_ok=ride_ok_next, tick=state.tick + 1, key=key
    )


def converged_fraction(state: DeltaState, faults: DeltaFaults = DeltaFaults()) -> torch.Tensor:
    """Fraction of (live node, rumor) pairs delivered, float32 0-d: per-row
    popcounts (exact in float32) summed in float32.  The sum's order is not
    the JAX package's, so the two agree to ~1e-7 relative, not bit for bit."""
    faults = resolve_faults(faults, state.tick)
    n, k = state.learned.shape[0], state.pcount.shape[1]
    bits = popcount_rows(state.learned).to(torch.float32)
    if faults.up is not None:
        live = faults.up
        denom = live.sum(dtype=torch.float32).clamp_min(1.0) * k
        return torch.where(live, bits, 0.0).sum() / denom
    return bits.sum() / (n * k)


def converged(state: DeltaState, faults: DeltaFaults = DeltaFaults()) -> torch.Tensor:
    """bool 0-d tensor on the state's device: have all rumors reached every
    live node?  (Dead rows are vacuously done.)"""
    faults = resolve_faults(faults, state.tick)
    k = state.pcount.shape[1]
    return unpack_bits(and_reduce_rows(state.learned, faults.up), k).all()


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

    state, blocks, done = until_loop(
        run_block, state, -(-max_ticks // check_every), lambda s: converged(s, faults)
    )
    return state, blocks * check_every, done


class DeltaSim:
    """Host-side convenience wrapper: params, state on ``device`` (the card
    unless the caller asks for the CPU), ``tick`` and
    ``run_until_converged``.  The run journal (``telemetry_sink``) is not
    ported yet."""

    def __init__(self, n: int, k: int, seed: int = 0, telemetry_sink=None,
                 device: DeviceLike = None, **kw):
        if telemetry_sink is not None:
            raise NotImplementedError(
                "DeltaSim(telemetry_sink=...) needs sim/telemetry, which is "
                "not ported yet (ROADMAP Queue A7)"
            )
        self.params = DeltaParams(n=n, k=k, **kw)
        self.state = init_state(self.params, seed=seed, device=device)

    def tick(self, faults: DeltaFaults = DeltaFaults()) -> DeltaState:
        self.state = step(self.params, self.state, faults)
        return self.state

    def run_until_converged(self, faults: DeltaFaults = DeltaFaults(), max_ticks: int = 10_000):
        self.state, ticks, ok = run_until_converged(
            self.params, self.state, faults, max_ticks=max_ticks
        )
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
