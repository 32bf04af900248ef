"""Scalable full-lifecycle SWIM simulator: failure detection at O(N·K).

Counterpart of ``ringpop_tpu/sim/lifecycle.py``, bit for bit under both of
its streams: ``rng="threefry"`` (the default, ``sim/threefry``) and
``rng="counter"`` (``sim/prng``).  The delta engine (``sim/delta.py``)
measures pure dissemination; this engine adds the failure-detection
dynamics of the reference — probe → indirect probe → Suspect → deadline →
Faulty → Tombstone → evict, and refutation by reincarnation
(``swim/node.go:470-513``, ``swim/state_transitions.go:90-117``,
``swim/memberlist.go:337-354``) — at O(N·K) memory.

Representation: every node's view is ``converged base ⊔ learned rumors``:

* ``base_{status,inc,present,pending,deadline}[N]`` — the view every node
  agrees on, and its per-subject timers;
* a K-slot rumor table ``(subject, incarnation, status, deadline)`` — the
  changes in flight (subject -1 = free slot);
* ``learned[N, W]`` (int32 holding the uint32 words of the K slot bits,
  ``sim/packbits``), ``pcount[N, K]`` (int8 piggyback counters) and the
  carried ``ride_ok[N, W] == pack_bool(pcount < max_p)``.

Change application is a lattice max over ``key = (incarnation << 3) |
state`` (``swim/member.py``), so a node's belief about subject ``s`` is
``max(base_key[s], max key of the learned slots about s)``.

On the card, three packed row reduces a tick run S1 (``csrc/packbits.cu``),
the per-slot first live learner runs L2 and the subject-slot walk under
:func:`detection_complete` and :func:`view_checksums` runs L1
(``csrc/lifecycle.cu``, ``ops/lifecycle_kernel.py``), and each threefry
draw runs T1 (``csrc/threefry.cu``, one launch a draw, the key kept on the
card); the rest of the tick is plain PyTorch.  The run loops are Python loops over blocks of
``check_every`` ticks with one host sync per block (``delta.until_loop``).

Where the JAX package's code is shaped by its SPMD partitioner, the port
takes the plain form the JAX docstrings prove value-identical: the
hierarchical candidate select ``_top_m_sparse`` is the full stable sort it
falls back to (``lax.top_k``: value descending, lower index first among
equals — one ``torch.sort(stable=True)``, not ``torch.topk``, which makes
no promise on ties), and the two-level ``_gather_rows`` is ``plane[idx]``.
The first-live-learner argmax, which the JAX package guards with a
``lax.cond`` on "a timer fired", is launched every tick with the tick's
``fire_s | fire_f`` as its ``want`` mask: the kernel decides on the card
(a block with no wanted slot exits at once), since a branch here would
cost a host sync a tick, and its value is masked by the same condition.

With a telemetry accumulator (``sim/telemetry``) the tick also counts its
protocol events, reading only what it computes anyway: on the card its
[N, W] and [N] legs are one launch of P1 and the journal's state digest one
launch of D1 (``csrc/telemetry.cu``).  ``faults`` may be a time-varying
``chaos.FaultPlan``, evaluated at the state's tick.

Sharded over a (P, R) mesh (``params.exchange_mesh``, a
``parallel.mesh.Mesh`` of more than one rank), the engine takes and returns
this rank's block: node rows block p of the planes and the per-node
vectors, and word block r of the packed planes (slot block r of
``pcount``); the rumor table, the tick and the key are whole on every
rank, and so are the faults.  A tick gathers the per-node vectors once and
computes every [N] and [K] vector and every draw whole on every rank.
Its cross-rank steps on the planes run over the node axis: the shift
exchange's two roll legs (``parallel/shift``; the uniform exchange gathers
the rows), the prober and subject rows of this rank's slots and the heal
pair's two rows (each owner supplies its rows), the three row reduces (S1
on each block, then the node axis combines), and L2's first live learner
(each rank's first row, the lowest over the node ranks that hold one).
The [K]-axis vectors the tick needs whole are gathered over the rumor axis
from the slot blocks: the prober's and the subject's own bits, the three
reduces' words and L2's answer (one gather each).  The queries take a
``mesh`` the same way: they gather a rank's rows over the rumor axis, then
L1 walks each node rank's rows and the node ranks OR their detect flags,
and ``view_checksums`` stays on the ranks that own the observer.  With a
telemetry accumulator its planes are word blocks and its per-node counters
row blocks (``telemetry.zeros``); ``telemetry.fetch`` gathers them.
``LifecycleSim(aot=)`` runs its blocks through the warm start
(``util/aot.py``).
"""

from __future__ import annotations

import functools
import hashlib
import time
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.ops import lifecycle_kernel
from ringpop_tpu_torch.sim import delta, prng, telemetry as _tm, threefry
from ringpop_tpu_torch.parallel.shift import shard_roll
from ringpop_tpu_torch.sim.delta import (
    DeltaFaults,
    check_tier_legs,
    clamped_max_p,
    has_drop,
    leg_survives,
    pair_connected,
    node_mesh,
    resolve_faults,
    resolve_max_p,
    rumor_block,
    sharding_of,
    tier_pair,
    tier_pair_drop,
    until_loop,
    whole_rows,
)
from ringpop_tpu_torch.sim.packbits import (
    and_reduce_rows_across,
    as_i32,
    bit_column,
    check_rumor_shardable,
    n_words,
    or_reduce_rows_across,
    pack_bool,
    row_mask,
    set_bit,
    set_bit_per_row,
    unpack_bits,
)
from ringpop_tpu_torch.swim.member import (
    ALIVE,
    FAULTY,
    KEY_STATE_BITS,
    SUSPECT,
    TOMBSTONE,
    is_detraction,
    is_pingable,
    key_incarnation,
    key_state,
    pack_key,
)

NO_DEADLINE = 2**31 - 1
INT32_MIN = -(2**31)

# the profiler ranges of ``step``, in order (the JAX package's phase scopes;
# "piggyback-counters" is entered twice, for the int8 passes A and B)
PHASES = (
    "tick-prologue", "ping-target", "rumor-exchange", "heal", "piggyback-counters",
    "timers-fold", "peer-choice", "candidate-select", "alloc-seed", "commit",
)


class LifecycleState(NamedTuple):
    # rumor table (K slots; subject -1 = free)
    r_subject: torch.Tensor  # int32[K]
    r_inc: torch.Tensor  # int32[K] incarnation (protocol-tick counter)
    r_status: torch.Tensor  # int8[K]
    r_deadline: torch.Tensor  # int32[K] tick when the state timer fires
    # per-(node, rumor); learned is bit-packed along the rumor axis
    learned: torch.Tensor  # int32[N, W] holding uint32 words, W = ceil(K/32)
    pcount: torch.Tensor  # int8[N, K]
    ride_ok: torch.Tensor  # int32[N, W]: pack_bool(pcount < clamped max_p), carried
    # converged base view shared by all nodes
    base_status: torch.Tensor  # int8[N]
    base_inc: torch.Tensor  # int32[N]
    base_present: torch.Tensor  # bool[N]
    base_pending: torch.Tensor  # int8[N] scheduled transition source state or -1
    base_deadline: torch.Tensor  # int32[N]
    # each node's own incarnation (refutation bumps it)
    self_inc: torch.Tensor  # int32[N]
    tick: torch.Tensor  # int32 scalar
    key: torch.Tensor  # int64[2] holding the uint32 PRNG key


@dataclass(frozen=True)
class LifecycleParams:
    n: int
    k: int = 128  # rumor-slot capacity
    # reference defaults in ticks (protocol period 200 ms, swim/node.go:74-100)
    suspect_ticks: int = 25  # 5 s
    faulty_ticks: int = 432000  # 24 h
    tombstone_ticks: int = 300  # 60 s
    ping_req_size: int = 3
    p_factor: int = 15
    max_p: Optional[int] = None
    alloc_per_tick: int = 64  # new-rumor budget per tick (<= k)
    tick_ms: int = 200  # simulated ms per tick (reporting only)
    # "shift": cyclic-permutation partners (one probe per target per tick);
    # "uniform": independent draws (see DeltaParams.exchange)
    exchange: str = "shift"
    # partition-healer attempt rate, cluster-wide per tick (~one attempt per
    # 10 s in the reference: swim/node.go:59-67, heal_via_discover_provider.go)
    heal_prob: float = 0.02
    # PRNG family: "threefry" = the jax.random draws (sim/threefry.py) the
    # frozen goldens pin; "counter" = the stateless stream of sim/prng.py
    rng: str = "threefry"
    # a parallel.mesh.Mesh of (P, R) ranks: the engine then takes and returns
    # this rank's block (parallel/mesh.with_exchange_mesh); the shift legs'
    # sub-block factor H is read only with a mesh, and exchange_pipelined
    # is kept for the JAX package's params and not read (delta.DeltaParams)
    exchange_mesh: Optional[Any] = None
    exchange_h: int = 2
    exchange_pipelined: bool = True

    def resolved_max_p(self) -> int:
        return resolve_max_p(self.n, self.p_factor, self.max_p)


def _check_supported(params: LifecycleParams) -> None:
    if params.rng not in ("threefry", "counter"):
        raise ValueError(f"unknown rng family {params.rng!r}")
    sharding_of(params)
    if params.rng == "counter" and params.ping_req_size >= prng.D_COLUMN_SPAN:
        raise ValueError(
            f"ping_req_size={params.ping_req_size} overflows the counter RNG's "
            f"per-site column span ({prng.D_COLUMN_SPAN}): column draws would "
            "collide with the next draw site's stream (sim/prng.py)"
        )


def init_state(params: LifecycleParams, seed: int = 0, device: DeviceLike = None) -> LifecycleState:
    """The initial state on ``device`` (the card unless the caller asks for
    the CPU; under a mesh, the mesh's device unless ``device`` is given);
    ``key`` is ``prng.prng_key(seed)``, the value ``jax.random.PRNGKey(seed)``
    has.  On the card, K is refused past the widest plane the lifecycle
    kernels take (``lifecycle_kernel.MAX_WORDS`` words) before anything is
    allocated."""
    sharding_of(params)  # ValueError when the ranks do not divide n
    dev = resolve_device(params.exchange_mesh.device if params.exchange_mesh is not None and device is None
                         else device)
    if dev.type == "cuda":
        lifecycle_kernel.check_width(n_words(params.k), "lifecycle.init_state")
    return init_state_from_key(params, prng.prng_key(seed, dev), dev)


def init_state_from_key(params: LifecycleParams, key, device: DeviceLike = None) -> LifecycleState:
    """The initial state with a given PRNG ``key`` leaf: the port's int64[2]
    tensor, or the JAX package's uint32[2] as numpy-convertible values.  The
    Monte-Carlo fleet (``sim/montecarlo``) builds its replicas this way.  On
    the card, K is refused past the widest plane the lifecycle kernels take
    rather than at the first tick.  Under a mesh (``delta.sharding_of``),
    this rank's block: its rows of the planes and per-node vectors, and its
    word (slot) block of the planes."""
    mesh = sharding_of(params)
    dev = resolve_device(params.exchange_mesh.device if params.exchange_mesh is not None and device is None
                         else device)
    k = params.k
    n = params.n // mesh.size if mesh is not None else params.n
    slots, words = rumor_block(mesh, k)
    kl = slots.stop - slots.start
    if dev.type == "cuda":
        lifecycle_kernel.check_width(n_words(k), "lifecycle.init_state")
    if isinstance(key, torch.Tensor):
        key = key.to(device=dev, dtype=torch.int64)
    else:
        key = torch.as_tensor(np.asarray(key).astype(np.uint32).astype(np.int64), device=dev)
    if key.shape != (2,):
        raise ValueError(f"a PRNG key is two uint32 words, got shape {tuple(key.shape)}")
    i32 = dict(dtype=torch.int32, device=dev)
    return LifecycleState(
        r_subject=torch.full((k,), -1, **i32),
        r_inc=torch.zeros((k,), **i32),
        r_status=torch.zeros((k,), dtype=torch.int8, device=dev),
        r_deadline=torch.full((k,), NO_DEADLINE, **i32),
        learned=torch.zeros((n, words.stop - words.start), **i32),
        pcount=torch.zeros((n, kl), dtype=torch.int8, device=dev),
        ride_ok=pack_bool(torch.zeros((n, kl), dtype=torch.int8, device=dev) < clamped_max_p(params)),
        base_status=torch.zeros((n,), dtype=torch.int8, device=dev),
        base_inc=torch.zeros((n,), **i32),
        base_present=torch.ones((n,), dtype=torch.bool, device=dev),
        base_pending=torch.full((n,), -1, dtype=torch.int8, device=dev),
        base_deadline=torch.full((n,), NO_DEADLINE, **i32),
        self_inc=torch.zeros((n,), **i32),
        tick=torch.zeros((), **i32),
        key=key,
    )


def _key_of(inc: torch.Tensor, status) -> torch.Tensor:
    """``member.pack_key`` in int32 (wraps for incarnations >= 2**28);
    ``status`` is a tensor or a state id."""
    if isinstance(status, torch.Tensor):
        status = status.to(torch.int32)
    return pack_key(inc.to(torch.int32), status)


def _status_of(key: torch.Tensor) -> torch.Tensor:
    return key_state(key).to(torch.int8)


_inc_of = key_incarnation


def _like(x: torch.Tensor, value: int) -> torch.Tensor:
    """A 0-d tensor of ``x``'s dtype and device: ``torch.where`` keeps the
    dtype of a tensor pair, where a Python scalar pair would promote."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def _segment_max(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max(vals, seg, num_segments=n + 1)[:n]``: an empty
    segment holds the dtype's minimum; segment ``n`` is the dump."""
    out = torch.full((n + 1,), INT32_MIN, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg.to(torch.int64), vals, "amax", include_self=True)[:n]


def _segment_min(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_min(..., num_segments=n + 1)[:n]``: an empty
    segment holds int32 max, which is ``NO_DEADLINE``."""
    out = torch.full((n + 1,), NO_DEADLINE, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg.to(torch.int64), vals, "amin", include_self=True)[:n]


def _scatter_any(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``jnp.zeros(n, bool).at[idx].max(vals, mode="drop")`` for indices in
    [0, n] (index n is dropped)."""
    out = torch.zeros(n + 1, dtype=torch.uint8, device=vals.device)
    out.scatter_reduce_(0, idx.to(torch.int64), vals.to(torch.uint8), "amax", include_self=True)
    return out[:n].to(torch.bool)


def _top_m(vals: torch.Tensor, m: int):
    """``lax.top_k(vals, m)``: the m largest values, descending, the lower
    index first among equals (one stable sort; int64 indices)."""
    v, i = torch.sort(vals, descending=True, stable=True)
    return v[:m], i[:m]


def _bel_rumor_dense(learned_b, r_subject, rkey, active, targets):
    """Per-node max learned-rumor key about its ping target — the general
    O(N·K) form (any target assignment; ``learned_b`` unpacked bool)."""
    bmask = learned_b & active[None, :] & (r_subject[None, :] == targets[:, None])
    return torch.where(bmask, rkey[None, :], -1).amax(dim=1).to(torch.int32)


# -- the cross-rank steps of a sharded tick ---------------------------------------

# the per-node vectors: node-sharded leaves a sharded tick gathers whole
_NODE_VECTORS = ("base_status", "base_inc", "base_present", "base_pending", "base_deadline", "self_inc")


def _whole_node_vectors(state: LifecycleState, mesh) -> LifecycleState:
    """``state`` with its per-node vectors gathered whole from every
    rank's block (one all_gather of an int32 stack; the planes stay this
    rank's rows); ``state`` itself with ``mesh`` None."""
    if mesh is None:
        return state
    stack = torch.stack([getattr(state, f).to(torch.int32) for f in _NODE_VECTORS])
    whole = mesh.all_gather(stack).transpose(0, 1).reshape(len(_NODE_VECTORS), -1)
    return state._replace(**{f: whole[i].to(getattr(state, f).dtype) for i, f in enumerate(_NODE_VECTORS)})


def _rows(mesh, plane: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """``plane[rows]`` of a plane that is whole, or under a mesh this
    rank's block (the owners supply the rows: ``Mesh.rows_of``)."""
    return plane[rows] if mesh is None else mesh.rows_of(plane, rows, n)


def _whole_slots(mesh, x: torch.Tensor) -> torch.Tensor:
    """A [..., kl] slot block (or [..., W/R] word block) whole along its
    last axis: every rumor rank's block in order (``Mesh.gather_cols``);
    ``x`` itself with ``mesh`` None or one rumor rank."""
    return x if mesh is None else mesh.gather_cols(x)


def _own_slot_bits(mesh, plane: torch.Tensor, rows: torch.Tensor, n: int, slots: slice) -> torch.Tensor:
    """bool[K]: slot j's bit of global row ``rows[j]`` (in [0, n)), for
    every slot j.  A rank reads the rows of its own slots (``rows[slots]``,
    their owners supplying them over the node axis) and the rumor axis
    gathers the slot blocks."""
    kl = slots.stop - slots.start
    got = _rows(mesh, plane, rows[slots], n)
    return _whole_slots(mesh, bit_column(got, torch.arange(kl, device=plane.device)))


def _local_slots(slots: torch.Tensor, ok: torch.Tensor, block: slice, k: int):
    """Global slot indices (in [0, k)) as indices into this rank's slot
    block, with ``ok`` kept only where the slot is in the block (each word
    block writes its own bits); unchanged when the block is the whole
    axis."""
    if block.stop - block.start == k:
        return slots, ok
    return (slots - block.start).clamp_min(0), ok & (slots >= block.start) & (slots < block.stop)


def _block_rows(mesh, rows: torch.Tensor, ok: torch.Tensor, n: int):
    """Global ``rows`` (in [0, n) where ``ok``) as indices into this rank's
    block, with ``ok`` kept only where this rank owns the row: each owner
    writes its own rows.  Unsharded, ``rows`` clamped into [0, n)."""
    rows = rows.clamp(0, n - 1)
    if mesh is None:
        return rows, ok
    lo, hi = mesh.block(n)
    return (rows - lo).clamp(0, hi - lo - 1), ok & (rows >= lo) & (rows < hi)


def _first_live_across(local_first: torch.Tensor, has_parts: torch.Tensor, mesh, k: int, block: int,
                       want: torch.Tensor) -> torch.Tensor:
    """L2's answer over every rank's block: each rank's lowest live
    learner (a row of its block; 0 also where it has none, so the rank's own
    OR words ``has_parts`` say where it has one) offset by its first row,
    the lowest over the ranks that have one; 0 where none has (the argmax
    of an all-False column) and for slots not in ``want``.  With ``mesh``
    None the block is the plane and ``local_first`` the answer."""
    if mesh is None:
        return local_first
    firsts = mesh.all_gather(local_first).to(torch.int64)
    has = unpack_bits(has_parts, k)
    offsets = torch.arange(has.shape[0], dtype=torch.int64, device=firsts.device)[:, None] * block
    none = torch.iinfo(torch.int64).max
    best = torch.where(has, firsts + offsets, none).amin(dim=0)
    return torch.where(want & (best < none), best, 0).to(torch.int32)


def step(
    params: LifecycleParams,
    state: LifecycleState,
    faults: DeltaFaults = DeltaFaults(),
    telemetry: Optional[_tm.TelemetryState] = None,
):
    """One protocol period for all N nodes, bit-equal to the JAX package's
    ``step`` under either stream.  ``faults`` may be a ``DeltaFaults`` or a
    plan with ``at_tick`` (evaluated at ``state.tick``).  The profiler
    ranges name the protocol phases as the JAX package's scopes do
    (:data:`PHASES`).  With ``telemetry`` (a ``telemetry.TelemetryState``)
    the tick also adds its counters to it, in place, and returns
    ``(state, telemetry)``; the new state is the same either way."""
    _check_supported(params)
    faults = resolve_faults(faults, state.tick)
    n, k = params.n, params.k
    dev = state.learned.device
    # under a mesh the planes are this rank's rows [lo, hi) of its slot
    # block ``sl`` (kl slots, word block ``wl``); the per-node vectors are
    # gathered whole here, every [N] and [K] vector below is whole, ``loc``
    # cuts this rank's rows out of one and ``sl``/``wl`` its slots and words
    mesh = sharding_of(params)
    rolls = node_mesh(mesh)
    lo, hi = mesh.block(n) if mesh is not None else (0, n)
    loc = slice(lo, hi)
    sl, wl = rumor_block(mesh, k)
    kl = sl.stop - sl.start
    state = _whole_node_vectors(state, mesh)
    with record_function("tick-prologue"):
        m = min(params.alloc_per_tick, params.k, params.n)
        maxp = clamped_max_p(params)
        use_counter = params.rng == "counter"
        if use_counter:
            # stateless counter stream: the key leaf carries the seed
            # material and the tick counter advances the stream
            key = state.key
            cseed = prng.fold_key(state.key)
            ctick = state.tick
        else:
            key, k_target, k_drop, k_peers, k_heal = threefry.split(state.key, 5)
        now = state.tick + 1
        i_all = torch.arange(n, dtype=torch.int64, device=dev)
        up_leg = faults.up
        up = up_leg if up_leg is not None else torch.ones(n, dtype=torch.bool, device=dev)

        has_topo = check_tier_legs(faults)
        if has_topo and not use_counter:
            raise ValueError(
                "topology tier legs need rng='counter': their loss coin is an extra "
                "stateless draw site; under threefry the extra split would shift every "
                "other draw"
            )
        # suspicion timeout: the static param unless the fault model carries
        # the override leg (-1 = "use the param")
        if faults.suspect_ticks is None:
            susp_ticks = params.suspect_ticks
        else:
            leg = torch.as_tensor(faults.suspect_ticks, device=dev).to(torch.int32)
            susp_ticks = torch.where(leg < 0, _like(leg, params.suspect_ticks), leg)

        active = state.r_subject >= 0
        rkey = torch.where(active, _key_of(state.r_inc, state.r_status), -1)
        # segment id n == dump bucket for free slots
        subj = torch.where(active, state.r_subject, n).to(torch.int64)
        subj_rumor_max = _segment_max(rkey, subj, n).clamp_min(-1)
        base_key = torch.where(state.base_present, _key_of(state.base_inc, state.base_status), -1)
        eff_max = torch.maximum(subj_rumor_max, base_key)
        active_w = pack_bool(active)[wl]  # this rank's words, tail bits zero

    with record_function("ping-target"):
        shift_mode = params.exchange == "shift"
        if shift_mode:
            shift = (prng.draw_randint(cseed, ctick, prng.D_SHIFT, 0, 1, n) if use_counter
                     else threefry.randint(k_target, (), 1, n)).to(torch.int64)
            targets = (i_all + shift) % n
            # each subject has exactly one prober (s - shift) mod n: K bit
            # gathers + one scatter-max instead of the O(N·K) masked reduce
            prober = (state.r_subject.to(torch.int64) - shift) % n
            pbit = _own_slot_bits(mesh, state.learned, prober.clamp(0, n - 1), n, sl)
            bel_vals = torch.where(active & pbit, rkey, -1)
            bel_rumor = torch.full((n + 1,), -1, dtype=torch.int32, device=dev).scatter_reduce_(
                0, torch.where(active, prober, n), bel_vals, "amax", include_self=True)[:n]
        else:
            targets = (prng.draw_randint(cseed, ctick, prng.D_TARGET, i_all, 0, n - 1) if use_counter
                       else threefry.randint(k_target, (n,), 0, n - 1)).to(torch.int64)
            targets = torch.where(targets >= i_all, targets + 1, targets)
            # the scatter by target reads every row: under a mesh the packed
            # plane's rows are gathered whole over the node axis, and the
            # rumor axis takes the max of the slot blocks' beliefs
            learned0_b = unpack_bits(whole_rows(state.learned, mesh), kl)
            bel_rumor = _bel_rumor_dense(learned0_b, state.r_subject[sl], rkey[sl], active[sl], targets)
            if mesh is not None and mesh.shape["rumor"] > 1:
                bel_rumor = mesh.all_gather(bel_rumor, "rumor").amax(dim=0)
        bel = torch.maximum(bel_rumor, base_key[targets])
        bel_status = _status_of(bel.clamp_min(0))
        believes_pingable = (bel >= 0) & is_pingable(bel_status)
        wants = up & believes_pingable

    with record_function("rumor-exchange"):
        conn = pair_connected(faults, i_all, targets)
        if has_drop(faults):
            drop_u = (prng.draw_uniform(cseed, ctick, prng.D_DROP, i_all) if use_counter
                      else threefry.uniform(k_drop, (n,)))
            conn &= leg_survives(faults, drop_u, i_all, targets)
        if has_topo:
            topo_u = prng.draw_uniform(cseed, ctick, prng.D_TOPO, i_all)
            conn &= topo_u >= tier_pair_drop(faults, i_all, targets)
        delivered = conn & wants

        if shift_mode:
            ride_ok_w = state.ride_ok
            dmask = row_mask(delivered)[loc]
            riding_w = state.learned & ride_ok_w & active_w[None, :]
            sent_w = riding_w & dmask
            # out[i] = in[(i - s) mod n]: rolls as row gathers, or under a
            # mesh the shift legs over the ranks' blocks (parallel/shift)
            idx_fwd = (i_all - shift) % n
            got_pinged = delivered.index_select(0, idx_fwd)[loc]
            if rolls is None:
                inbound_w = sent_w.index_select(0, idx_fwd)
            else:
                # the shift picks the legs' send plan on the host: one sync a tick
                s_host = int(shift)
                (inbound_w,) = shard_roll((sent_w,), s_host, rolls, "node", h=params.exchange_h)
            learned1_w = state.learned | inbound_w
            answerable_w = learned1_w & ride_ok_w & active_w[None, :]
            if rolls is None:
                resp_src = answerable_w.index_select(0, (i_all + shift) % n)
            else:
                (resp_src,) = shard_roll((answerable_w,), n - s_host, rolls, "node", h=params.exchange_h)
            resp_w = resp_src & dmask
            learned2_w = learned1_w | resp_w
            newly_w = learned2_w & ~state.learned
        else:
            # under a mesh the gate comes from the carried ride_ok, gathered
            # whole (pack_bool(pcount < max_p) by construction)
            ride_ok_b = (state.pcount < maxp if mesh is None
                         else unpack_bits(mesh.gather_rows(state.ride_ok), kl))
            riding_b = learned0_b & active[sl][None, :] & ride_ok_b
            sent_b = riding_b & delivered[:, None]
            # segment_max of bools by target: a max over duplicate targets
            inbound_b = torch.zeros((n, kl), dtype=torch.uint8, device=dev).scatter_reduce_(
                0, targets[:, None].expand(n, kl), sent_b.to(torch.uint8), "amax", include_self=True
            ).to(torch.bool)
            got_pinged = torch.zeros(n, dtype=torch.uint8, device=dev).scatter_reduce_(
                0, targets, delivered.to(torch.uint8), "amax", include_self=True
            ).to(torch.bool)
            learned1_b = learned0_b | inbound_b
            answerable_b = learned1_b & active[sl][None, :] & ride_ok_b
            resp_b = answerable_b[targets] & delivered[:, None]
            learned2_b = learned1_b | resp_b
            learned2_w = pack_bool(learned2_b[loc])

    with record_function("heal"):
        # one probabilistic attempt per tick: a random connected pair swaps
        # its full rumor set (AttemptHeal's join + membership merge)
        if params.heal_prob > 0:
            if use_counter:
                h = prng.draw_randint(cseed, ctick, prng.D_HEAL_A, 0, 0, n).to(torch.int64)
                p = prng.draw_randint(cseed, ctick, prng.D_HEAL_B, 0, 0, n).to(torch.int64)
                heal_u = prng.draw_uniform(cseed, ctick, prng.D_HEAL_U, 0)
            else:
                kh1, kh2, kh3 = threefry.split(k_heal, 3)
                h = threefry.randint(kh1, (), 0, n).to(torch.int64)
                p = threefry.randint(kh2, (), 0, n).to(torch.int64)
                heal_u = threefry.uniform(kh3, ())
            attempt = (
                (heal_u < torch.tensor(params.heal_prob, dtype=torch.float32, device=dev))
                & (h != p)
                & up[h]
                & up[p]
                & pair_connected(faults, h[None], p[None])[0]
            )
            heal_rows2 = torch.stack([h, p])
            rows_hp = _rows(mesh, learned2_w, heal_rows2, n)  # [2, W]
            merged_row = (rows_hp[0] | rows_hp[1]) & active_w
            if mesh is None:
                # the 2-row swap, in place: learned2_w is this tick's own
                # plane, and its only other reader (newly_w) is taken above
                learned2_w[heal_rows2] = torch.where(attempt, merged_row[None, :], rows_hp)
            else:
                # each owner writes its own row of the pair
                node_ids = torch.arange(lo, hi, device=dev)
                healed = attempt & ((node_ids == h) | (node_ids == p))
                learned2_w = torch.where(healed[:, None], merged_row[None, :], learned2_w)
            merged_bits = unpack_bits(merged_row, kl)
        learned2h_w = learned2_w

    with record_function("piggyback-counters"):
        # -- pcount pass A: bump + newly-learned + heal resets
        if shift_mode:
            # bump = sent + (riding & got_pinged) = riding * (delivered + got)
            bump = unpack_bits(riding_w, kl).to(torch.int8) * (
                delivered[loc].to(torch.int8) + got_pinged.to(torch.int8))[:, None]
            newly_bit = unpack_bits(newly_w, kl)
        else:
            bump = (sent_b.to(torch.int8) + (riding_b & got_pinged[:, None]).to(torch.int8))[loc]
            newly_bit = (learned2_b & ~learned0_b)[loc]
        # a bump lands only where pcount < max_p <= 126: the int8 sum stays <= 127
        pcount_a = (state.pcount + bump).clamp_max(maxp).masked_fill(newly_bit, 0)
        if params.heal_prob > 0:
            # heal resets (a join transfer restarts dissemination of all it
            # carried), as the same 2-row write
            if mesh is None:
                pcount_a[heal_rows2] = torch.where(
                    attempt & merged_bits[None, :], _like(pcount_a, 0), pcount_a[heal_rows2])
            else:
                pcount_a = pcount_a.masked_fill(healed[:, None] & merged_bits[None, :], 0)

        # full-sync analog: re-seed rumors that expired short of full
        # coverage.  The three row reduces read the up mask directly
        mid_ride_w = pack_bool(pcount_a < maxp)
        riding_now_w = learned2h_w & mid_ride_w & active_w[None, :]
        up_loc = None if up_leg is None else up_leg[loc]
        # S1 over each block, the node axis' words combined; the OR keeps
        # each node rank's own words for L2's combine below.  The three
        # word blocks are gathered whole over the rumor axis in one go
        fully_w = and_reduce_rows_across(learned2h_w, up_loc, mesh)
        live_w, live_parts = or_reduce_rows_across(learned2h_w, up_loc, mesh, partials=True)
        riding_live_w = or_reduce_rows_across(riding_now_w, up_loc, mesh)
        if kl != k:
            fully_w, live_w, riding_live_w = mesh.gather_cols(torch.stack([fully_w, live_w, riding_live_w])).unbind(0)
        fully_learned = unpack_bits(fully_w, k) & active
        has_live_learner = unpack_bits(live_w, k)
        stuck = active & ~unpack_bits(riding_live_w, k) & ~fully_learned

    with record_function("timers-fold"):
        # -- timers fire: slot rumors (state_transitions.go:90-117)
        subj_c = subj.clamp(0, n - 1)
        due = active & (state.tick >= state.r_deadline)
        dominant = rkey >= eff_max[subj_c]
        fire = due & dominant
        fire_subj = subj_c
        # a transition fires only where some live node can seed the successor
        fire_s = fire & (state.r_status == SUSPECT) & has_live_learner
        fire_f = fire & (state.r_status == FAULTY) & has_live_learner
        # eviction additionally waits for the tombstone to be fully disseminated
        fire_t = fire & (state.r_status == TOMBSTONE) & fully_learned
        fire_sf = fire_s | fire_f
        slot_next = torch.where(fire_s, _like(state.r_status, FAULTY), _like(state.r_status, TOMBSTONE))
        slot_cand = torch.where(fire_sf, _key_of(state.r_inc, slot_next), -1)
        fire_key = _segment_max(slot_cand, subj, n).clamp_min(-1)
        # seed of a fired transition: the first live node that learned the
        # rumor (L2 on the card), for the slots of fire_s | fire_f only — the
        # JAX package's lax.cond, decided on the card with no host sync
        slot_seed = _whole_slots(mesh, _first_live_across(
            lifecycle_kernel.first_live_learner(learned2h_w, up_loc, kl, want=fire_sf[sl]),
            live_parts, mesh, kl, hi - lo, fire_sf[sl]))
        seed_node = _segment_max(torch.where(fire_sf, slot_seed, -1), subj, n).clamp_min(-1)
        r_deadline = state.r_deadline

        # dominated base timers cancel; due + dominant base timers fire
        bdue = (state.base_pending >= 0) & (state.tick >= state.base_deadline) & state.base_present
        bdom = base_key >= subj_rumor_max
        bfire = bdue & bdom
        base_pending = torch.where(bdue & ~bdom, _like(state.base_pending, -1), state.base_pending)
        bfire_s = bfire & (state.base_pending == SUSPECT)
        bfire_f = bfire & (state.base_pending == FAULTY)
        bfire_t = bfire & (state.base_pending == TOMBSTONE)
        # the first True of up (argmax of a bool: cast first)
        first_live = up_leg.to(torch.int32).argmax() if up_leg is not None else torch.zeros(
            (), dtype=torch.int64, device=dev)
        bfire_key = torch.where(
            bfire_s | bfire_f,
            _key_of(state.base_inc, torch.where(bfire_s, _like(state.base_status, FAULTY),
                                                _like(state.base_status, TOMBSTONE))),
            -1,
        )
        # slot-fired rumors keep their first live learner; base-fired ones
        # seed at the first live node.  Ties keep the slot's learner
        seed_node = torch.where(bfire_key > fire_key, first_live.to(torch.int32), seed_node)
        fire_key = torch.maximum(fire_key, bfire_key)

        # -- evictions (tombstone timer expired; memberlist.Evict analog)
        evicted = _scatter_any(n, subj_c, fire_t) | bfire_t
        base_present = state.base_present & ~evicted
        freed_by_evict = active & evicted[subj_c]

        # -- fold fully learned dominant rumors into the base
        foldable = fully_learned & (rkey >= eff_max[subj_c]) & ~freed_by_evict
        folded_key = _segment_max(torch.where(foldable, rkey, -1), subj, n).clamp_min(-1)
        fold_mask = folded_key >= 0
        folded0 = folded_key.clamp_min(0)
        base_status = torch.where(fold_mask, _status_of(folded0), state.base_status)
        base_inc = torch.where(fold_mask, _inc_of(folded0), state.base_inc)
        base_present = base_present | fold_mask
        # the folded rumor's pending deadline moves to the base timer
        fold_dl = _segment_min(
            torch.where(foldable & (rkey == folded_key[subj_c]), r_deadline, NO_DEADLINE), subj, n)
        base_pending = torch.where(
            fold_mask,
            torch.where(fold_dl < NO_DEADLINE, _status_of(folded0), _like(base_pending, -1)),
            base_pending,
        )
        base_deadline = torch.where(fold_mask, fold_dl, state.base_deadline)
        # free every slot of a folded subject, and dead rumors whose only
        # learners have crashed
        freed = freed_by_evict | (active & fold_mask[subj_c]) | (active & ~has_live_learner)
        r_subject = torch.where(freed, _like(state.r_subject, -1), state.r_subject)
        learned3_w = learned2h_w & ~pack_bool(freed)[wl][None, :]
        active = r_subject >= 0
        base_key = torch.where(base_present, _key_of(base_inc, base_status), -1)
        subj = torch.where(active, r_subject, n).to(torch.int64)
        subj_rumor_max = _segment_max(
            torch.where(active, _key_of(state.r_inc, state.r_status), -1), subj, n).clamp_min(-1)
        eff_max = torch.maximum(subj_rumor_max, base_key)

    with record_function("peer-choice"):
        # the [N, P] indirect-probe draws: elementwise in (node, column)
        pcols = torch.arange(params.ping_req_size, dtype=torch.int64, device=dev)[None, :]
        lanes = i_all[:, None]
        if use_counter:
            peer_choices = prng.draw_randint(cseed, ctick, prng.D_PEER + pcols, lanes, 0, n).to(torch.int64)
            if has_drop(faults):
                pd_req_u = prng.draw_uniform(cseed, ctick, prng.D_PEER_DROP_REQ + pcols, lanes)
                pd_ack_u = prng.draw_uniform(cseed, ctick, prng.D_PEER_DROP_ACK + pcols, lanes)
        else:
            k_peers, k_pd1, k_pd2 = threefry.split(k_peers, 3)
            peer_choices = threefry.randint(k_peers, (n, params.ping_req_size), 0, n).to(torch.int64)
            if has_drop(faults):
                pd_req_u = threefry.uniform(k_pd1, peer_choices.shape)
                pd_ack_u = threefry.uniform(k_pd2, peer_choices.shape)
        if has_topo:
            topo_req_u = prng.draw_uniform(cseed, ctick, prng.D_TOPO_PEER_REQ + pcols, lanes)
            topo_ack_u = prng.draw_uniform(cseed, ctick, prng.D_TOPO_PEER_ACK + pcols, lanes)

    with record_function("candidate-select"):
        # -- refutation candidates (memberlist.go:337-354): only (node ==
        # slot subject) pairs self-detect, so K bit gathers + one scatter
        subj_c = subj.clamp(0, n - 1)
        own_bit = _own_slot_bits(mesh, learned3_w, subj_c, n, sl)
        slot_self_detract = (
            active & own_bit & is_detraction(state.r_status) & (state.r_inc >= state.self_inc[subj_c])
        )
        self_detract = _scatter_any(n, subj, slot_self_detract)
        base_detract = is_detraction(base_status) & (base_inc >= state.self_inc) & base_present
        refute = up & (self_detract | base_detract)
        refute_key = torch.where(refute, _key_of(now, ALIVE), -1)

        # -- failed probe → indirect probes → Suspect (node.go:494-510)
        probing = wants & ~conn
        i_bcast = lanes.expand(peer_choices.shape)
        targets_b = targets[:, None].expand(peer_choices.shape)
        peer_ok = (
            pair_connected(faults, i_bcast, peer_choices)
            & (peer_choices != i_bcast)
            & (peer_choices != targets_b)
        )
        peer_reaches = peer_ok & pair_connected(faults, peer_choices, targets_b) & up[targets][:, None]
        # each indirect leg is its own RPC and suffers packet loss too
        if has_drop(faults):
            peer_ok &= leg_survives(faults, pd_req_u, i_bcast, peer_choices)
            peer_reaches &= peer_ok & leg_survives(faults, pd_ack_u, peer_choices, targets_b)
        if has_topo:
            peer_ok &= topo_req_u >= tier_pair_drop(faults, i_bcast, peer_choices)
            peer_reaches &= peer_ok & (topo_ack_u >= tier_pair_drop(faults, peer_choices, targets_b))
        reached = peer_reaches.any(dim=1)
        inconclusive = (~peer_ok).all(dim=1)
        declare = probing & ~reached & ~inconclusive
        susp_cand = torch.where(declare, _key_of(_inc_of(bel.clamp_min(0)), SUSPECT), -1)
        susp_key = _segment_max(susp_cand, torch.where(declare, targets, n), n).clamp_min(-1)
        susp_key = torch.where(susp_key > eff_max, susp_key, -1)

        # -- merge per-subject candidates & allocate into free slots
        cand = torch.maximum(torch.maximum(refute_key, susp_key), fire_key)
        cand_vals, cand_subj = _top_m(cand, m)
        free_vals, free_slots = _top_m((~active).to(torch.int32), m)

    with record_function("alloc-seed"):
        place = (cand_vals >= 0) & (free_vals == 1)
        new_status = _status_of(cand_vals.clamp_min(0))
        new_inc = _inc_of(cand_vals.clamp_min(0))
        tick = state.tick
        new_dl = torch.where(
            new_status == SUSPECT,
            tick + susp_ticks,
            torch.where(
                new_status == FAULTY,
                tick + params.faulty_ticks,
                torch.where(new_status == TOMBSTONE, tick + params.tombstone_ticks, _like(tick, NO_DEADLINE)),
            ),
        ).to(torch.int32)
        r_subject = r_subject.clone()
        r_subject[free_slots] = torch.where(place, cand_subj.to(torch.int32), r_subject[free_slots])
        r_inc = state.r_inc.clone()
        r_inc[free_slots] = torch.where(place, new_inc, r_inc[free_slots])
        r_status = state.r_status.clone()
        r_status[free_slots] = torch.where(place, new_status, r_status[free_slots])
        r_deadline = r_deadline.clone()
        r_deadline[free_slots] = torch.where(place, new_dl, r_deadline[free_slots])

        # fresh slots start unlearned, then get seeded
        placed_col = torch.zeros(k, dtype=torch.bool, device=dev)
        placed_col[free_slots] = place
        learned4_w = learned3_w & ~pack_bool(placed_col)[wl][None, :]

        # seed row per placed candidate: refute → the subject itself; timer
        # transition → first live learner of the precursor.  Fresh suspect
        # rumors are seeded by their declarers below
        seed_rows = torch.where(new_status == ALIVE, cand_subj, seed_node[cand_subj].to(torch.int64))
        seed_ok = place & (new_status != SUSPECT) & (seed_rows >= 0)
        seed_rows, seed_ok = _block_rows(mesh, seed_rows, seed_ok, n)
        seed_slots, seed_ok = _local_slots(free_slots, seed_ok, sl, k)
        learned5_w = set_bit(learned4_w, seed_rows, seed_slots, seed_ok)
        # suspect rumors: every declarer that targeted the subject seeds it
        subj_to_slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
        subj_to_slot[cand_subj] = torch.where(place & (new_status == SUSPECT), free_slots, -1)
        decl_slot = subj_to_slot[targets]
        decl_ok = declare & (decl_slot >= 0)
        decl_cols, decl_on = _local_slots(decl_slot.clamp(0, k - 1)[loc], decl_ok[loc], sl, k)
        learned6_w = set_bit_per_row(learned5_w, decl_cols, decl_on)

    with record_function("piggyback-counters"):
        # -- pcount pass B: the deferred stuck/freed/placed clears
        cleared = freed | placed_col
        learned2h_b = unpack_bits(learned2h_w, kl)
        pcount_final = pcount_a.masked_fill(cleared[sl][None, :] | (stuck[sl][None, :] & learned2h_b), 0)
        # the carried gate invariant ride_ok == pack(pcount < max_p): a reset
        # to zero opens the gate iff max_p > 0
        reset_w = pack_bool(cleared)[wl][None, :] | (pack_bool(stuck)[wl][None, :] & learned2h_w)
        if maxp <= 0:
            reset_w = torch.zeros_like(reset_w)
        ride_next = mid_ride_w | reset_w

    with record_function("commit"):
        # refutation bumps the refuter's own incarnation iff its rumor placed
        placed_subject = torch.zeros(n, dtype=torch.bool, device=dev)
        placed_subject[cand_subj] = place & (new_status == ALIVE)
        self_inc = torch.where(refute & placed_subject, now, state.self_inc)
        # deferred timer clears: a fired timer retires once a rumor at least
        # as strong as its successor was allocated for its subject
        placed_key = torch.full((n,), -1, dtype=torch.int32, device=dev)
        placed_key[cand_subj] = torch.where(place, cand_vals, -1)
        slot_fired_ok = fire_sf & (placed_key[fire_subj] >= slot_cand) & ~placed_col
        r_deadline = torch.where(slot_fired_ok, _like(r_deadline, NO_DEADLINE), r_deadline)
        base_fired_ok = ((bfire_s | bfire_f) & (bfire_key >= 0) & (placed_key >= bfire_key)) | bfire_t
        base_pending = torch.where(base_fired_ok, _like(base_pending, -1), base_pending)

    new_state = LifecycleState(
        r_subject=r_subject,
        r_inc=r_inc,
        r_status=r_status,
        r_deadline=r_deadline,
        learned=learned6_w,
        pcount=pcount_final,
        ride_ok=ride_next,
        base_status=base_status,
        base_inc=base_inc,
        base_present=base_present,
        base_pending=base_pending,
        base_deadline=base_deadline,
        self_inc=self_inc,
        tick=state.tick + 1,
        key=key,
    )
    if mesh is not None:
        new_state = new_state._replace(**{f: getattr(new_state, f)[loc].clone() for f in _NODE_VECTORS})
    if telemetry is None:
        return new_state

    # -- telemetry: reads of what the tick computed above, written nowhere
    # but the accumulators (the JAX package's "telemetry" scope)
    with record_function("telemetry"):
        # under a mesh the accumulator holds this rank's rows (and words)
        if not shift_mode:
            sent_w, resp_w = pack_bool(sent_b[loc]), pack_bool(resp_b[loc])
        # per-tier suspicion flow (armed accumulators and a topology-carrying
        # plan): the tier of each accuser -> target pair, and whether the
        # plan had the target live
        declared = declared_tier = declared_up = None
        if telemetry.suspects_by_tier is not None and has_topo:
            declared = decl_ok[loc]
            declared_tier = tier_pair(faults, i_all[loc], targets[loc])
            declared_up = up[targets[loc]]
        telemetry = _tm.accumulate(
            telemetry,
            declared=declared,
            declared_tier=declared_tier,
            declared_up=declared_up,
            delivered=delivered[loc],
            probing=probing[loc],
            peer_ok=peer_ok[loc],
            refute=refute[loc],
            placed=placed_subject[loc],
            sent_w=sent_w,
            resp_w=resp_w,
            # the gates that closed this tick: the tick-entry gate less the
            # gate after the bump
            ride_ok=state.ride_ok,
            mid_ride_w=mid_ride_w,
            # timers count at retirement, not at firing: a fired timer that
            # could not place its successor refires every tick until it lands
            fired=slot_fired_ok | fire_t,
            base_fired=base_fired_ok[loc],
            place=place,
            new_status=new_status,
            heal_attempt=attempt if params.heal_prob > 0 else None,
        )
    return new_state, telemetry


# -- membership operations -------------------------------------------------------


def admit(params: LifecycleParams, state: LifecycleState, idx: int) -> LifecycleState:
    """Admit (or re-admit) node ``idx``: the join path's Alive rumor at a
    fresh incarnation, seeded only at the joiner, in the first free slot
    (``swim/join_sender.go``).  Reads the rumor table on the host; raises if
    it is full.  Under a mesh, ``state`` is this rank's block."""
    free = np.flatnonzero(state.r_subject.cpu().numpy() < 0)
    if free.size == 0:
        raise RuntimeError("rumor table full; cannot admit now")
    k0 = int(free[0])
    now = int(state.tick) + 1
    mesh = sharding_of(params)
    lo, hi = mesh.block(params.n) if mesh is not None else (0, params.n)
    sl, _ = rumor_block(mesh, params.k)
    dev = state.learned.device
    learned, pcount, ride_ok = state.learned.clone(), state.pcount.clone(), state.ride_ok.clone()
    if sl.start <= k0 < sl.stop:  # the slot's word block writes its bits
        kb = k0 - sl.start
        w0 = kb >> 5
        bitv = int(as_i32(torch.tensor(1 << (kb & 31))))
        col = (state.learned[:, w0] & ~bitv) | torch.where(
            torch.arange(lo, hi, device=dev) == idx, bitv, 0).to(torch.int32)
        # slot k0's counters reset to 0, so its carried ride gate opens
        # (unless max_p = 0, where nothing ever rides)
        if clamped_max_p(params) > 0:
            ride_col = state.ride_ok[:, w0] | bitv
        else:
            ride_col = state.ride_ok[:, w0] & ~bitv
        learned[:, w0] = col
        pcount[:, kb] = 0
        ride_ok[:, w0] = ride_col
    r_subject, r_inc, r_status, r_deadline, self_inc = (
        x.clone() for x in (state.r_subject, state.r_inc, state.r_status, state.r_deadline, state.self_inc))
    r_subject[k0] = idx
    r_inc[k0] = now
    r_status[k0] = ALIVE
    r_deadline[k0] = NO_DEADLINE
    if lo <= idx < hi:  # the joiner's owner bumps its incarnation
        self_inc[idx - lo] = now
    return state._replace(
        r_subject=r_subject, r_inc=r_inc, r_status=r_status, r_deadline=r_deadline,
        learned=learned, pcount=pcount, ride_ok=ride_ok, self_inc=self_inc,
    )


# -- queries -----------------------------------------------------------------


def _rkey(state: LifecycleState) -> torch.Tensor:
    return torch.where(state.r_subject >= 0, _key_of(state.r_inc, state.r_status), -1)


def _base_key(state: LifecycleState) -> torch.Tensor:
    return torch.where(state.base_present, _key_of(state.base_inc, state.base_status), -1)


def _subjects(subjects, device) -> torch.Tensor:
    if isinstance(subjects, torch.Tensor):
        return subjects.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(subjects, np.int64).reshape(-1), device=device)


def believed_key(state: LifecycleState, subjects) -> torch.Tensor:
    """int32[N, S]: node i's belief key about each subject (-1 = not
    present).  O(N·K·S) — for small subject lists."""
    dev = state.learned.device
    subjects = _subjects(subjects, dev)
    k = state.r_subject.shape[0]
    active = state.r_subject >= 0
    sel = active[:, None] & (state.r_subject[:, None] == subjects[None, :])  # [K, S]
    per_rumor = torch.where(sel, _rkey(state)[:, None], -1)  # [K, S]
    bel_rumor = torch.where(unpack_bits(state.learned, k)[:, :, None], per_rumor[None], -1).amax(dim=1)
    return torch.maximum(bel_rumor, _base_key(state)[subjects][None, :]).to(torch.int32)


def believed_status(state: LifecycleState, subjects) -> torch.Tensor:
    """int8[N, S]: belief status; -1 where the subject is absent."""
    bk = believed_key(state, subjects)
    return torch.where(bk >= 0, _status_of(bk.clamp_min(0)), _like(_status_of(bk), -1))


def _observers(state: LifecycleState, subjects: torch.Tensor, faults: DeltaFaults,
               n: Optional[int] = None) -> torch.Tensor:
    n = state.learned.shape[0] if n is None else n
    dev = state.learned.device
    up = faults.up if faults.up is not None else torch.ones(n, dtype=torch.bool, device=dev)
    is_subject = torch.zeros(n, dtype=torch.bool, device=dev)
    is_subject[subjects] = True
    return up & ~is_subject


def detection_fraction(
    state: LifecycleState,
    subjects,
    faults: DeltaFaults = DeltaFaults(),
    min_status: int = FAULTY,
) -> torch.Tensor:
    """float32[S]: fraction of live observers whose belief about each
    subject has reached ``min_status`` (or the subject is evicted).  Past
    2**28 elements of N·K·S the slot walk of
    :func:`_detection_fraction_large` computes the same from [N] columns."""
    faults = resolve_faults(faults, state.tick)
    n_subj = len(subjects)
    if state.learned.shape[0] * state.r_subject.shape[0] * n_subj > 2**28:
        return _detection_fraction_large(state, subjects, faults, min_status)
    subjects = _subjects(subjects, state.learned.device)
    bk = believed_key(state, subjects)
    detected = (bk < 0) | (_status_of(bk.clamp_min(0)) >= min_status)
    observer = _observers(state, subjects, faults)
    num = (detected & observer[:, None]).sum(dim=0, dtype=torch.int32)
    den = observer.sum(dtype=torch.int32).clamp_min(1)
    return num.to(torch.float32) / den.to(torch.float32)


def _detection_fraction_large(
    state: LifecycleState,
    subjects,
    faults: DeltaFaults = DeltaFaults(),
    min_status: int = FAULTY,
) -> torch.Tensor:
    """Exact large-scale :func:`detection_fraction`: per subject, walk its
    slots in descending key order, counting observers whose FIRST learned
    slot is each one (prefix exclusion over [N] columns); observers that
    learned none fall through to the base.  The quotient is taken in float64
    and rounded to float32, as the JAX package's ``jnp.asarray`` of its
    float64 numpy result does."""
    subjects_np = np.asarray(subjects, np.int64).reshape(-1)
    r_subject = state.r_subject.cpu().numpy()
    r_key = (state.r_inc.cpu().numpy().astype(np.int64) << KEY_STATE_BITS) | state.r_status.cpu().numpy()
    active = r_subject >= 0
    base_present = state.base_present.cpu().numpy()[subjects_np]
    base_inc = state.base_inc.cpu().numpy().astype(np.int64)[subjects_np]
    base_status = state.base_status.cpu().numpy()[subjects_np]
    base_key = (base_inc << KEY_STATE_BITS) | base_status
    obs = _observers(state, torch.as_tensor(subjects_np, device=state.learned.device), faults)
    obs_total = int(obs.sum())
    frac = np.zeros(len(subjects_np), np.float64)
    for si, s in enumerate(subjects_np):
        slots = np.flatnonzero(active & (r_subject == s))
        order = slots[np.argsort(-r_key[slots], kind="stable")]
        remaining = obs  # observers not yet governed by a higher-key rumor
        count = 0
        for slot in order:
            if base_present[si] and base_key[si] >= r_key[slot]:
                break  # the base outranks this and every lower slot
            col = ((state.learned[:, int(slot) >> 5] >> int(slot & 31)) & 1) != 0
            got = remaining & col
            if int(r_key[slot] & (2**KEY_STATE_BITS - 1)) >= min_status:
                count += int(got.sum())
            remaining = remaining & ~col
        # fall-through: governed by the base (an absent subject is detected)
        if (not base_present[si]) or int(base_status[si]) >= min_status:
            count += int(remaining.sum())
        frac[si] = count / max(obs_total, 1)
    return torch.as_tensor(frac.astype(np.float32), device=state.learned.device)


def _slot_covered(state: LifecycleState, n: Optional[int] = None) -> torch.Tensor:
    """bool[N]: which subject ids hold at least one in-flight rumor slot."""
    n = state.learned.shape[0] if n is None else n
    active = state.r_subject >= 0
    return _scatter_any(n, torch.where(active, state.r_subject, n), active)


def _walk_subject_slots(state: LifecycleState, base_key: torch.Tensor, mode: str,
                        obs: Optional[torch.Tensor] = None, min_status: int = 0,
                        learned: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-subject slot walk under :func:`detection_complete` and
    :func:`view_checksums`: the K slots sorted by (subject asc, key desc),
    free slots last, each node's governing key per covered subject combined
    by ``mode`` (``ops.lifecycle_kernel.slot_walk``: L1 on the card).  The
    walk reads ``learned`` (default: the state's plane), whose rows may be a
    rank's block; subjects range over ``base_key``'s N."""
    n = base_key.shape[0]
    order, sorted_subj, sorted_key = lifecycle_kernel.walk_order(state.r_subject, _rkey(state), n)
    return lifecycle_kernel.slot_walk(state.learned if learned is None else learned, order, sorted_subj,
                                      sorted_key, base_key, mode, obs, min_status)


def _mesh_of(mesh, learned_sharding=None):
    """The mesh a query spans: ``mesh``, else the hint's, when it has more
    than one rank; else None."""
    if mesh is None and learned_sharding is not None:
        mesh = learned_sharding.mesh
    return mesh if mesh is not None and mesh.sharded else None


def _whole_word_rows(state: LifecycleState, mesh) -> LifecycleState:
    """``state`` with its per-node vectors gathered whole and ``learned``
    this rank's rows with every word (its word block gathered over the
    rumor axis): what the slot walk reads, as the JAX package's
    ``learned_sharding=P("node", None)`` hint lays it out."""
    state = _whole_node_vectors(state, mesh)
    return state._replace(learned=_whole_slots(mesh, state.learned))


def detection_complete(
    state: LifecycleState,
    subjects,
    faults: DeltaFaults = DeltaFaults(),
    min_status: int = FAULTY,
    *,
    learned_sharding=None,
    mesh=None,
) -> torch.Tensor:
    """bool 0-d tensor on the state's device: does every live observer
    believe every subject has reached ``min_status`` (or see it evicted)?
    Same predicate as ``(detection_fraction(...) >= 1).all()``, including
    "no live observers → not complete", in O(N·K) through the slot walk.

    With a ``mesh`` (or ``learned_sharding``'s mesh), ``state`` is this
    rank's block and the answer is the whole state's, on every rank (a
    collective); a rank's rows are first gathered over the rumor axis.  ``learned_sharding`` (a
    ``partition.NamedSharding``) names the layout the walk reads the plane
    in, and so only the route: a spec whose axis 0 is ``"node"`` (or no
    hint) walks each rank's rows and ORs the ranks' flags; a replicated
    spec gathers the plane whole once per check and walks it on every rank.
    The value is the same either way."""
    faults = resolve_faults(faults, state.tick)
    mesh = _mesh_of(mesh, learned_sharding)
    with record_function("detect-walk"):
        subjects = _subjects(subjects, state.learned.device)
        if mesh is None:
            base_bad = state.base_present & (state.base_status < min_status)
            obs = _observers(state, subjects, faults)
            anybad = _walk_subject_slots(state, _base_key(state), "detect", obs, min_status)
            not_detected = torch.where(_slot_covered(state), anybad, base_bad)[subjects]
            return obs.any() & ~not_detected.any()
        n = state.learned.shape[0] * mesh.size
        lo, hi = mesh.block(n)
        state = _whole_word_rows(state, mesh)
        base_bad = state.base_present & (state.base_status < min_status)
        obs = _observers(state, subjects, faults, n)
        if learned_sharding is not None and learned_sharding.spec[:1] != ("node",):
            anybad = _walk_subject_slots(state, _base_key(state), "detect", obs, min_status,
                                         learned=mesh.gather_rows(state.learned))
        else:
            local = _walk_subject_slots(state, _base_key(state), "detect", obs[lo:hi], min_status)
            anybad = unpack_bits(mesh.or_words(pack_bool(local)), n)
        not_detected = torch.where(_slot_covered(state, n), anybad, base_bad)[subjects]
        return obs.any() & ~not_detected.any()


def view_checksums(state: LifecycleState, faults: DeltaFaults = DeltaFaults(), mesh=None) -> torch.Tensor:
    """int64[N] holding uint32: an order-invariant checksum of each node's
    membership view — the wrapping uint32 sum of ``mix32(mix32(s) ^ key)``
    over every subject ``s`` present in the node's view with its governing
    key, tombstones excluded (``memberlist.go:106-128``).  Subjects with a
    slot go through the slot walk (L1 on the card); the rest are the same
    in every view: one shared term.  ``faults`` is accepted for symmetry
    with the other queries and not read.  With a ``mesh``, ``state`` is
    this rank's block and the result its rows' (its observers' checksums:
    ``partition.host_gather`` assembles them, and every rumor rank of a row
    block holds the same)."""
    del faults
    mesh = _mesh_of(mesh)
    with record_function("view-checksum"):
        if mesh is not None:
            state = _whole_word_rows(state, mesh)
        base_key = _base_key(state)
        n = base_key.shape[0]
        acc = _walk_subject_slots(state, base_key, "checksum")
        i_all = torch.arange(n, dtype=torch.int64, device=state.learned.device)
        base_terms = torch.where(~_slot_covered(state, n), lifecycle_kernel.member_term(i_all, base_key), 0)
        return (acc + base_terms.sum()) & 0xFFFF_FFFF


def checksums_converged(state: LifecycleState, faults: DeltaFaults = DeltaFaults(), mesh=None) -> torch.Tensor:
    """bool 0-d tensor: do all live nodes' view checksums agree (and is any
    node live)?  The reference's convergence criterion for protocol tests
    (``swim/test_utils.go:164-199``).  With a ``mesh`` the checksums are
    gathered whole over the node axis (a collective)."""
    faults = resolve_faults(faults, state.tick)
    mesh = _mesh_of(mesh)
    cs = view_checksums(state, faults, mesh)
    if mesh is not None:
        cs = mesh.gather_rows(cs)
    up = faults.up if faults.up is not None else torch.ones(cs.shape[0], dtype=torch.bool, device=cs.device)
    first = cs[up.to(torch.int32).argmax()]
    return (torch.where(up, cs, first) == first).all() & up.any()


# -- run loops -----------------------------------------------------------------


def _run_block(params: LifecycleParams, state: LifecycleState, faults, ticks: int, telemetry=None):
    """``ticks`` steps.  With a telemetry accumulator the carry is the
    (state, telemetry) pair; with None the loop is the telemetry-free one."""
    if telemetry is None:
        for _ in range(ticks):
            state = step(params, state, faults)
        return state
    for _ in range(ticks):
        state, telemetry = step(params, state, faults, telemetry)
    return state, telemetry


def _quiescent(state: LifecycleState, faults, mesh=None) -> torch.Tensor:
    """No rumor slot in flight and every live view checksum agrees (both
    sides evaluated, as the JAX package does: no host branch)."""
    return ~(state.r_subject >= 0).any() & checksums_converged(state, faults, mesh)


def _carry_loop(params: LifecycleParams, state, faults, telemetry, block_ticks: int, max_blocks: int, pred):
    """``until_loop`` over blocks of ``block_ticks`` ticks, carrying the
    (state, telemetry) pair when a telemetry accumulator rides along.
    Returns (state, blocks, done), with the telemetry appended when given."""
    if telemetry is None:
        return until_loop(lambda s: _run_block(params, s, faults, block_ticks), state, max_blocks, pred)
    (state, telemetry), blocks, done = until_loop(
        lambda c: _run_block(params, c[0], faults, block_ticks, c[1]), (state, telemetry), max_blocks,
        lambda c: pred(c[0]))
    return state, blocks, done, telemetry


def _run_until_converged_device(params: LifecycleParams, state: LifecycleState, faults, *,
                                block_ticks: int, max_blocks: int, telemetry=None):
    """Up to ``max_blocks`` blocks of ``block_ticks`` ticks until no change
    is in flight and all live checksums agree, tested on entry and after
    each block (``delta.until_loop``: one host sync per block).  Returns
    (state, blocks_run, converged), with the accumulated telemetry appended
    when a telemetry accumulator rides the carry."""
    mesh = sharding_of(params)
    return _carry_loop(params, state, faults, telemetry, block_ticks, max_blocks,
                       lambda s: _quiescent(s, faults, mesh))


def _run_until_detected_device(params: LifecycleParams, state: LifecycleState, faults,
                               subjects: torch.Tensor, *, min_status: int, block_ticks: int,
                               max_blocks: int, telemetry=None, learned_sharding=None):
    """Up to ``max_blocks`` blocks of ``block_ticks`` ticks until
    :func:`detection_complete` holds, tested on entry and after each block.
    Returns (state, blocks_run, detected), with the telemetry appended as
    :func:`_run_until_converged_device` does.  Under a mesh the test spans
    the ranks (``learned_sharding`` picks its route)."""
    mesh = sharding_of(params)
    return _carry_loop(params, state, faults, telemetry, block_ticks, max_blocks,
                       lambda s: detection_complete(s, subjects, faults, min_status,
                                                    learned_sharding=learned_sharding, mesh=mesh))


class LifecycleSim:
    """Host-side wrapper: params, state on ``device`` (the card unless the
    caller asks for the CPU), ``tick``, ``run`` and the run-until pair with
    the JAX package's loop and budget contract (:meth:`_run_until`).

    ``telemetry``: False/None (the default) leaves the tick untouched.
    True, or a ``telemetry.TelemetrySink``, carries the counter
    accumulators through every tick; each ``run`` / ``run_until_*``
    dispatch then fetches one block record and, when a sink is attached,
    hands it over with the state's digest (``state_digest``) attached, and
    with ``journal_views`` also the wrapped sum of the view checksums
    (``views_sum``) and their live agreement (``views_agree``).
    ``telemetry_tiers`` arms the per-tier suspicion counters.  ``aot="tag"``
    sends every distinct block program :meth:`run` dispatches through the
    warm-start front door (``util/aot.py``), one memoized runner per block
    length, faults descriptor and telemetry on or off; ``aot_info`` collects
    one front-door record per program.  With ``exchange_mesh`` (a (P, R) mesh) the
    state and the accumulators are this rank's block, every rank calls each
    method in step with the others, and every rank's records are the whole
    state's."""

    def __init__(self, n: int, seed: int = 0, telemetry=None, journal_views: bool = False,
                 aot: Optional[str] = None, telemetry_tiers: bool = False, device: DeviceLike = None, **kw):
        self.params = LifecycleParams(n=n, **kw)
        _check_supported(self.params)
        self.state = init_state(self.params, seed=seed, device=device)
        self._aot_tag = aot
        self._aot_calls: dict = {}
        self.aot_info: dict = {}
        self.telemetry = None
        self.telemetry_sink = None
        self.journal_views = journal_views
        if telemetry:
            self.telemetry = _tm.zeros(self.params, tiers=telemetry_tiers, device=self.state.learned.device)
            self.telemetry_sink = telemetry if callable(telemetry) else None

    def tick(self, faults: DeltaFaults = DeltaFaults()) -> LifecycleState:
        if self.telemetry is None:
            self.state = step(self.params, self.state, faults)
        else:
            self.state, self.telemetry = step(self.params, self.state, faults, self.telemetry)
        return self.state

    def _block_call(self, state, faults, ticks: int, telemetry=None):
        """One block of ``ticks`` ticks, through the warm-start front door
        when the instance carries a tag: one runner per (ticks, faults
        structure and leaf descriptors, telemetry on or off), so a faults
        tree of another structure or shape gets its own keyed program."""
        dyn_kw = {} if telemetry is None else {"telemetry": telemetry}
        if self._aot_tag is None:
            return _run_block(self.params, state, faults, ticks, **dyn_kw)
        from ringpop_tpu_torch.util import aot as _aot

        fdesc = _aot.tree_descriptor(faults)
        memo = (ticks, fdesc, telemetry is not None)
        if memo not in self._aot_calls:
            # a short hash of the faults descriptor keeps the records of two
            # programs at one block size from overwriting each other
            tag = (f"{self._aot_tag}-blk{ticks}" + ("-tm" if telemetry is not None else "")
                   + f"-f{hashlib.sha256(fdesc.encode()).hexdigest()[:6]}")
            call, info = _aot.load_or_compile(
                functools.partial(_run_block, self.params), state, faults, dyn_kw=dyn_kw or None,
                tag=tag, static_kw={"ticks": ticks}, statics=(repr(self.params),))
            self._aot_calls[memo] = call
            self.aot_info[tag] = info
        return self._aot_calls[memo](state, faults, **dyn_kw)

    def run(self, ticks: int, faults: DeltaFaults = DeltaFaults()) -> LifecycleState:
        if self.telemetry is None:
            self.state = self._block_call(self.state, faults, ticks)
        else:
            self.state, self.telemetry = self._block_call(self.state, faults, ticks, telemetry=self.telemetry)
            self._flush(faults)
        return self.state

    # -- telemetry plumbing -------------------------------------------------

    def fetch_telemetry(self, faults: DeltaFaults = DeltaFaults()) -> Optional[dict]:
        """Fetch and reset the accumulated block record as host scalars
        (one copy); None when telemetry is off."""
        if self.telemetry is None:
            return None
        record, self.telemetry = _tm.fetch(self.telemetry, self.state, faults, sharding_of(self.params))
        return {k: (v.item() if isinstance(v, torch.Tensor) else v) for k, v in record.items()}

    def _flush(self, faults: DeltaFaults) -> None:
        """Fetch the block record and hand it to the sink (if any), with the
        state digest (D1) attached and, with ``journal_views``, the view
        checksums' wrapped sum and live agreement (L1's checksum mode)."""
        if self.telemetry_sink is None:
            return
        mesh = sharding_of(self.params)
        record, self.telemetry = _tm.fetch(self.telemetry, self.state, faults, mesh)
        extra = {"state_digest": _tm.tree_digest(self.state, mesh)}
        if self.journal_views:
            views = view_checksums(self.state, faults, mesh)
            extra["views_sum"] = (views if mesh is None else mesh.gather_rows(views)).sum() & 0xFFFF_FFFF
            extra["views_agree"] = checksums_converged(self.state, faults, mesh)
        self.telemetry_sink(record, **extra)

    def _run_until(self, dispatch, max_ticks: int, check_every: int, blocks_per_dispatch: int,
                   time_budget_s: Optional[float]):
        """The JAX package's budgeted run-until loop: ``dispatch(max_blocks)``
        runs up to that many ``check_every``-tick blocks with the early-exit
        test between them and returns (blocks, done).  With a time budget the
        first dispatch runs one block to measure block cost, then dispatch
        sizes adapt to the remaining budget (up to ``blocks_per_dispatch``);
        an overrun stops with partial progress.  A zero or exhausted tick
        budget still dispatches once with 0 blocks: the entry check runs
        without stepping.  Returns (ticks_used, done)."""
        deadline = None if time_budget_s is None else time.perf_counter() + time_budget_s
        bpd = 1 if deadline is not None else blocks_per_dispatch
        ticks = 0
        while True:
            max_blocks = min(bpd, max(0, (max_ticks - ticks) // check_every))
            t0 = time.perf_counter()
            n_blocks, done = dispatch(max_blocks)
            now = time.perf_counter()
            ticks += n_blocks * check_every
            if done:
                return ticks, True
            if max_blocks == 0 or ticks + check_every > max_ticks:
                return ticks, False
            if deadline is not None:
                if now > deadline:
                    return ticks, False
                per_block = (now - t0) / max(n_blocks, 1)
                bpd = max(1, min(blocks_per_dispatch, int((deadline - now) / max(per_block, 1e-9))))

    def run_until_converged(
        self,
        faults: DeltaFaults = DeltaFaults(),
        max_ticks: int = 5000,
        check_every: int = 8,
        blocks_per_dispatch: int = 4,
        time_budget_s: Optional[float] = None,
    ):
        """Tick until no change is in flight and every live node's view
        checksum agrees (``swim/test_utils.go:164-199``).  Returns
        (ticks_used, converged)."""

        def dispatch(max_blocks):
            if self.telemetry is None:
                self.state, blocks, done = _run_until_converged_device(
                    self.params, self.state, faults, block_ticks=check_every, max_blocks=max_blocks)
            else:
                self.state, blocks, done, self.telemetry = _run_until_converged_device(
                    self.params, self.state, faults, block_ticks=check_every, max_blocks=max_blocks,
                    telemetry=self.telemetry)
                self._flush(faults)
            return blocks, done

        return self._run_until(dispatch, max_ticks, check_every, blocks_per_dispatch, time_budget_s)

    def run_until_detected(
        self,
        subjects: Sequence[int],
        faults: DeltaFaults = DeltaFaults(),
        min_status: int = FAULTY,
        max_ticks: int = 5000,
        check_every: int = 8,
        time_budget_s: Optional[float] = None,
        blocks_per_dispatch: int = 4,
        learned_sharding=None,
    ):
        """Tick until every live observer believes every subject has reached
        ``min_status``.  Returns (ticks_used, detected).  Under a mesh,
        ``learned_sharding`` picks the detection test's route
        (:func:`detection_complete`); the result is the same either way."""
        subjects = _subjects(list(subjects), self.state.learned.device)

        def dispatch(max_blocks):
            if self.telemetry is None:
                self.state, blocks, done = _run_until_detected_device(
                    self.params, self.state, faults, subjects, min_status=min_status,
                    block_ticks=check_every, max_blocks=max_blocks, learned_sharding=learned_sharding)
            else:
                self.state, blocks, done, self.telemetry = _run_until_detected_device(
                    self.params, self.state, faults, subjects, min_status=min_status,
                    block_ticks=check_every, max_blocks=max_blocks, telemetry=self.telemetry)
                self._flush(faults)
            return blocks, done

        return self._run_until(dispatch, max_ticks, check_every, blocks_per_dispatch, time_budget_s)


def state_shardings(mesh, k: Optional[int] = None) -> LifecycleState:
    """A ``LifecycleState`` of ``partition.NamedSharding`` over ``mesh``,
    one a leaf, from the canonical rule table
    (``partition.PARTITION_RULES``): per-node vectors and the big planes on
    the node axis, the planes' words (slots) and the rumor table on the
    rumor axis, the rest replicated (the port holds the rumor table whole:
    ``partition``).  ``k`` is validated against the mesh's rumor axis
    (``packbits.check_rumor_shardable``)."""
    from ringpop_tpu_torch.parallel.partition import named_shardings

    if k is not None:
        check_rumor_shardable(k, mesh.shape["rumor"])
    return named_shardings(LifecycleState(**{f: 0 for f in LifecycleState._fields}), mesh)


# -- carrying a JAX state across ------------------------------------------------

_LEAF_DTYPES = {  # leaf -> (JAX numpy dtype, port torch dtype)
    "r_subject": (np.int32, torch.int32),
    "r_inc": (np.int32, torch.int32),
    "r_status": (np.int8, torch.int8),
    "r_deadline": (np.int32, torch.int32),
    "learned": (np.uint32, torch.int32),
    "pcount": (np.int8, torch.int8),
    "ride_ok": (np.uint32, torch.int32),
    "base_status": (np.int8, torch.int8),
    "base_inc": (np.int32, torch.int32),
    "base_present": (np.bool_, torch.bool),
    "base_pending": (np.int8, torch.int8),
    "base_deadline": (np.int32, torch.int32),
    "self_inc": (np.int32, torch.int32),
    "tick": (np.int32, torch.int32),
    "key": (np.uint32, torch.int64),
}


def state_from_numpy(leaves, device: DeviceLike = None) -> LifecycleState:
    """A ``LifecycleState`` on ``device`` from the JAX package's leaves (a
    JAX ``LifecycleState`` or any sequence in its field order, as
    numpy-convertible arrays): uint32 planes cross as their int32 bit
    pattern, the key as int64.  On the card, a plane wider than the
    lifecycle kernels take (``lifecycle_kernel.MAX_WORDS`` words) is refused
    here, before anything is uploaded, as :func:`init_state` refuses it."""
    dev = resolve_device(device)
    leaves = list(leaves)
    if dev.type == "cuda":
        learned = leaves[LifecycleState._fields.index("learned")]
        lifecycle_kernel.check_width(int(np.shape(learned)[-1]), "lifecycle.state_from_numpy")
    out = []
    for name, leaf in zip(LifecycleState._fields, leaves):
        np_dtype, dtype = _LEAF_DTYPES[name]
        arr = np.asarray(leaf).astype(np_dtype, copy=False)
        if dtype == torch.int32 and np_dtype == np.uint32:
            arr = arr.view(np.int32)
        elif dtype == torch.int64:
            arr = arr.astype(np.int64)
        out.append(torch.as_tensor(np.array(arr), device=dev))
    return LifecycleState(*out)


def state_to_numpy(state: LifecycleState) -> LifecycleState:
    """The leaves as numpy arrays of the JAX package's dtypes."""
    out = []
    for name, leaf in zip(LifecycleState._fields, state):
        np_dtype, _ = _LEAF_DTYPES[name]
        arr = leaf.detach().cpu().numpy()
        out.append(arr.view(np_dtype) if arr.dtype.itemsize == np.dtype(np_dtype).itemsize
                   else arr.astype(np_dtype))
    return LifecycleState(*out)


faults_from_numpy = delta.faults_from_numpy

