"""Exact full-view SWIM simulator: the whole cluster as (N × N) tensors.

Counterpart of ``ringpop_tpu/sim/fullview.py``, bit for bit, with targets
and ping-req peers injected (the lockstep conformance gate,
``sim/conformance``) and with the engine's own threefry draws (crashes,
partitions and loss).  ``view[i, j]`` is what node i believes of member j.
One tick is one protocol period for every node (parity: ``swim/gossip.go:178``
→ ``node.go:470-513`` → ``memberlist.go:310-390``):

* change application is the lattice max over ``(incarnation << 3) |
  state`` (``swim.member.pack_key``), with refutation, the first-seen
  tombstone refusal and the suspicion timers (``memberlist.go:337-354,
  421-426``, ``state_transitions.go:90-160``);
* a failed direct probe goes to k indirect probes, then Suspect
  (``node.go:494-510``, all-errors inconclusive rule included);
* a ping answered with no changes against a differing view is answered
  with the full membership, both ways (``disseminator.go:156-304``).

On the card, each change application is one launch of the hand-written
Hopper kernel F1 (``ops/fullview_kernel.py``, ``csrc/fullview.cu``), five a
tick, and the ping target and ping-req peer draws are kernel C1
(``csrc/threefry.cu``), the masked categorical draw without its ``[N, N]``
and ``[N, 3, N]`` Gumbel planes; the key splits and drop coins are T1.
The rest is plain PyTorch: the scatter-max by target is a
``scatter_reduce_`` ``amax`` onto a plane of -1 (max is order-free, so the
card's atomics are exact), the per-target count an ``index_add_``.

:func:`step` is pure, as the JAX package's: it copies the planes once and
advances the copies in place (F1 writes them).  Incarnations are
wall-ms (``tick_ms`` a tick) and a candidate key must stay >= 0, so a tick
whose ms would reach :data:`MAX_INCARNATION` (2**28, about 1.34M ticks at
200 ms) is refused by :meth:`FullViewSim.tick`.  ``maxP``'s
``ceil(log10(num + 1))`` is taken as an integer digit count
(:func:`decimal_digits`): equal to the float32 expression on the CPU for
every count (``tests/test_torch_fullview.py``), while the card's
``log10f`` promises no such thing at ``num + 1 = 10**k`` — a converged 1k
cluster has exactly 999 pingable members.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.ops import fullview_kernel
from ringpop_tpu_torch.sim import prng, threefry
from ringpop_tpu_torch.sim.delta import pair_connected
from ringpop_tpu_torch.swim.member import (  # noqa: F401  (STATE_BITS: the conformance harness's)
    ALIVE,
    FAULTY,
    KEY_STATE_BITS as STATE_BITS,
    LEAVE,
    SUSPECT,
    TOMBSTONE,
    pack_key,
)


class FullViewState(NamedTuple):
    """One tuple = the whole simulated cluster."""

    status: torch.Tensor  # int8[N, N]   view[i, j]
    incarnation: torch.Tensor  # int32[N, N], ms since sim epoch
    present: torch.Tensor  # bool[N, N]  j exists in i's member table
    has_change: torch.Tensor  # bool[N, N] i has a dissemination record about j
    pcount: torch.Tensor  # int32[N, N] piggyback counter
    pending: torch.Tensor  # int8[N, N]  scheduled transition source state or -1
    deadline: torch.Tensor  # int32[N, N] tick at which the transition fires
    tick: torch.Tensor  # int32 scalar, sim time in protocol periods
    key: torch.Tensor  # int64[2] holding the uint32 PRNG key


@dataclass(frozen=True)
class FullViewParams:
    n: int
    # reference defaults expressed in ticks (protocol period = 200ms):
    suspect_ticks: int = 25  # 5s / 200ms   (swim/node.go:74)
    faulty_ticks: int = 432000  # 24h
    tombstone_ticks: int = 300  # 60s
    ping_req_size: int = 3  # swim/node.go:86
    p_factor: int = 15  # disseminator.go:35
    tick_ms: int = 200  # ms of simulated time per tick


# the profiler ranges of ``step``, in order
PHASES = ("request", "full-sync", "response", "piggyback", "ping-req", "timers")

# the planes of FullViewState, in field order
PLANES = FullViewState._fields[:7]

# the first incarnation whose key ``(inc << STATE_BITS) | state`` is negative:
# a candidate key of -1 means none, so every incarnation stays below it
MAX_INCARNATION = 2 ** (31 - STATE_BITS)


def _now_ms(params: FullViewParams, tick: torch.Tensor) -> torch.Tensor:
    # relative wall-ms: strictly positive so refutes always exceed the
    # converged base incarnation (0)
    return (tick.to(torch.int32) + 1) * params.tick_ms


def _key_of(inc: torch.Tensor, status: torch.Tensor) -> torch.Tensor:
    """Override-order key: lexicographic (incarnation, precedence) as one
    int32."""
    return pack_key(inc.to(torch.int32), status.to(torch.int32))


def init_state(
    params: FullViewParams, seed: int = 0, converged: bool = True, device: DeviceLike = None
) -> FullViewState:
    """All nodes alive; everyone knows everyone (converged) or only itself.
    ``key`` is ``prng.prng_key(seed)``, the value ``jax.random.PRNGKey(seed)``
    has."""
    dev = resolve_device(device)
    n = params.n
    present = (torch.ones((n, n), dtype=torch.bool, device=dev) if converged
               else torch.eye(n, dtype=torch.bool, device=dev))
    return FullViewState(
        status=torch.zeros((n, n), dtype=torch.int8, device=dev),
        incarnation=torch.zeros((n, n), dtype=torch.int32, device=dev),  # converged base = incarnation 0
        present=present,
        has_change=torch.zeros((n, n), dtype=torch.bool, device=dev),
        pcount=torch.zeros((n, n), dtype=torch.int32, device=dev),
        pending=torch.full((n, n), -1, dtype=torch.int8, device=dev),
        deadline=torch.zeros((n, n), dtype=torch.int32, device=dev),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
        key=prng.prng_key(seed, dev),
    )


@dataclass(frozen=True)
class Faults:
    """Fault model for a step: ``up`` bool[N] process liveness, ``group``
    int32[N] partition group (-1 = all), both tensors on the state's device
    or None, and ``drop_rate`` the per-message loss probability, a Python
    number (static, as the JAX package keeps it)."""

    up: Optional[torch.Tensor] = None
    group: Optional[torch.Tensor] = None
    drop_rate: float = 0.0


def _connectivity(params: FullViewParams, faults: Faults, key: torch.Tensor, targets: torch.Tensor):
    """conn[i] = can i's ping reach targets[i] this tick."""
    n = params.n
    up = faults.up if faults.up is not None else torch.ones(n, dtype=torch.bool, device=targets.device)
    conn = up & up[targets]
    if faults.group is not None:
        g = faults.group
        gt = g[targets]
        conn &= (g < 0) | (gt < 0) | (g == gt)
    if faults.drop_rate > 0:
        conn &= threefry.uniform(key, (n,)) >= _rate(faults)
    return conn, up


def _rate(faults: Faults) -> torch.Tensor:
    """The drop rate as the float32 the JAX comparison converts it to: a
    0-dim CPU tensor, which compares with CUDA operands without a copy."""
    return torch.tensor(faults.drop_rate, dtype=torch.float32)


# 10**9 is the largest power of ten below 2**31
DIGITS = 10


def decimal_digits(num):
    """``ceil(log10(num + 1))`` for counts ``num >= 0`` below 2**31, as
    integer compares: the number of decimal digits of ``num`` (0 for 0).
    Works on ints, numpy arrays and tensors (an int64 result)."""
    return sum((num >= 10**k) * 1 for k in range(DIGITS))


def _pingable(status: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """present & (Alive or Suspect) & off the diagonal."""
    pingable = present & ((status == ALIVE) | (status == SUSPECT))
    pingable.diagonal().zero_()
    return pingable


def _max_p_of(params: FullViewParams, pingable: torch.Tensor) -> torch.Tensor:
    return (params.p_factor * decimal_digits(pingable.sum(dim=1))).to(torch.int32)


def _max_p(params: FullViewParams, status: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Per-node dissemination bound maxP = pFactor * ceil(log10(pingable+1))
    (parity: ``disseminator.go:75-97``), int32[N]."""
    return _max_p_of(params, _pingable(status, present))


def _apply_batch(params: FullViewParams, state: FullViewState, cand_key: torch.Tensor,
                 now_ms: torch.Tensor) -> FullViewState:
    """Apply a batch of candidate changes (one key a (observer, subject)
    cell, already max-merged; -1 = none) to the state's planes in place —
    the array form of ``memberlist.Update``: F1 on the card, its plain
    version on the CPU (``ops/fullview_kernel.py``)."""
    fullview_kernel.apply(
        state[:7], cand_key, state.tick, now_ms,
        (params.suspect_ticks, params.faulty_ticks, params.tombstone_ticks))
    return state


def _segment_max(rows: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """out[t] = the elementwise max of the rows i with targets[i] == t, -1
    where none (``segment_max`` clamped at -1; every key is >= -1)."""
    n = rows.shape[0]
    out = torch.full_like(rows, -1)
    return out.scatter_reduce_(0, targets[:, None].expand(n, rows.shape[1]), rows, "amax", include_self=True)


def _fire_timers(params: FullViewParams, state: FullViewState, now_ms: torch.Tensor) -> FullViewState:
    """Deadline-array transitions (``state_transitions.go:90-117``): the
    timer fires a Make{Faulty,Tombstone} / Evict, which is itself a local
    change."""
    due = (state.pending >= 0) & (state.tick >= state.deadline)

    # suspect->faulty, faulty->tombstone at the member's current incarnation
    fire_faulty = due & (state.pending == SUSPECT)
    fire_tomb = due & (state.pending == FAULTY)
    fire_evict = due & (state.pending == TOMBSTONE)

    cand_status = torch.where(fire_faulty, FAULTY, torch.where(fire_tomb, TOMBSTONE, 0)).to(torch.int8)
    cand_key = torch.where(fire_faulty | fire_tomb, _key_of(state.incarnation, cand_status), -1)

    state.pending.masked_fill_(due, -1)
    _apply_batch(params, state, cand_key, now_ms)

    # eviction removes the member entirely (memberlist.Evict; never self —
    # self never gets a timer)
    state.present.masked_fill_(fire_evict, False)
    state.has_change.masked_fill_(fire_evict, False)
    return state


def step(
    params: FullViewParams,
    state: FullViewState,
    faults: Faults = Faults(),
    targets: Optional[torch.Tensor] = None,
    peers: Optional[torch.Tensor] = None,
) -> FullViewState:
    """One protocol period for every node: the next state (``state`` is
    left as it was; copies of its planes are advanced in place).
    ``targets`` (int[N]) and ping-req ``peers`` (int[N, ping_req_size])
    may be injected for
    deterministic conformance runs — with both injected and ``drop_rate
    == 0`` the step is a function of the state alone, which is what the
    lockstep harness in ``sim.conformance`` relies on."""
    n = params.n
    # the planes are advanced in place on a copy; tick and key are new leaves
    state = state._replace(**{name: getattr(state, name).clone() for name in PLANES})
    dev = state.status.device
    keys = threefry.split(state.key, 4)
    k_target, k_drop, k_peers = keys[1], keys[2], keys[3]
    now = _now_ms(params, state.tick)
    i_all = torch.arange(n, device=dev)

    with record_function("request"):
        # -- ping target selection (memberlist_iter.go round-robin becomes a
        # masked categorical draw; injectable for lockstep conformance)
        pingable = _pingable(state.status, state.present)
        any_pingable = pingable.any(dim=1)
        if targets is None:
            # a row with no pingable member draws over the whole row (the
            # JAX package's safe logits)
            targets = threefry.categorical_masked(k_target, pingable)
        targets = torch.as_tensor(targets, device=dev).to(torch.int64)

        conn, up = _connectivity(params, faults, k_drop, targets)
        delivered = conn & any_pingable & up  # dead/idle nodes don't ping

        max_p = _max_p_of(params, pingable)

        # -- request leg: senders' unexpired changes, max-merged per target
        send_mask = state.has_change & (state.pcount < max_p[:, None]) & delivered[:, None]
        send_key = torch.where(send_mask, _key_of(state.incarnation, state.status), -1)
        # scatter-max by target: concurrent pings to one node merge exactly
        # because application is a lattice max
        _apply_batch(params, state, _segment_max(send_key, targets), now)

    with record_function("full-sync"):
        # (disseminator.go:156-181): target had no changes to answer with
        # AND the sender's view differs from its own
        present_t = state.present[targets]
        status_t = state.status[targets]
        inc_t = state.incarnation[targets]
        has_any = state.has_change.any(dim=1)
        both = state.present & present_t
        cell_eq = torch.where(both, (state.status == status_t) & (state.incarnation == inc_t),
                              state.present == present_t)
        views_equal = cell_eq.all(dim=1)
        full_sync = delivered & ~has_any[targets] & ~views_equal

    with record_function("response"):
        # target's changes (or full membership on full sync)
        resp_mask = state.has_change[targets] & (state.pcount[targets] < max_p[targets][:, None])
        resp_mask = torch.where(full_sync[:, None], present_t, resp_mask)
        resp_key = torch.where(resp_mask & delivered[:, None], _key_of(inc_t, status_t), -1)
        _apply_batch(params, state, resp_key, now)

        # reverse full sync (disseminator.go:257-304): the target pulls the
        # sender's membership too — scatter the sender's full view at the target
        rfs_key = torch.where((full_sync & delivered)[:, None] & state.present,
                              _key_of(state.incarnation, state.status), -1)
        _apply_batch(params, state, _segment_max(rfs_key, targets), now)

    with record_function("piggyback"):
        # counter bumps + expiry (disseminator.go:128-153); the sender bumps
        # on success only (ping_sender.go:52)
        recv_count = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, targets, delivered.to(torch.int32))
        receiver_bump = state.has_change & (recv_count[:, None] > 0) & (state.pcount < max_p[:, None])
        pcount = state.pcount + send_mask.to(torch.int32) + receiver_bump.to(torch.int32)
        expired = pcount >= max_p[:, None]
        state.pcount.copy_(pcount.masked_fill_(expired, 0))
        state.has_change.masked_fill_(expired, False)

    with record_function("ping-req"):
        # failed probe: indirect ping-req then Suspect (node.go:494-510)
        probing = any_pingable & up & ~delivered
        # peers drawn from each node's pingable view excluding the target
        # (memberlist.go:200-218 RandomPingableMembers; with replacement here)
        peer_pool = pingable
        peer_pool[i_all, targets] = False
        if peers is None:
            peer_choices = threefry.categorical_masked(k_peers, peer_pool, reps=params.ping_req_size)
        else:
            peer_choices = torch.as_tensor(peers, device=dev)
        peer_choices = peer_choices.to(torch.int64)
        i_idx = i_all[:, None].expand(peer_choices.shape)
        # static (loss-free) connectivity of each leg (sim.delta.pair_connected)
        peer_ok = peer_pool.gather(1, peer_choices) & pair_connected(faults, i_idx, peer_choices)
        peer_reaches = peer_ok & pair_connected(faults, peer_choices, targets[:, None].expand(peer_choices.shape))
        # each indirect leg is its own RPC and suffers packet loss too (drawn
        # only when drop_rate > 0, so deterministic conformance runs keep
        # their documented draw order)
        if faults.drop_rate > 0:
            k_pd = threefry.split(threefry.fold_in(k_peers, 1), 2)
            rate = _rate(faults)
            peer_ok &= threefry.uniform(k_pd[0], tuple(peer_choices.shape)) >= rate
            peer_reaches &= peer_ok & (threefry.uniform(k_pd[1], tuple(peer_choices.shape)) >= rate)
        if faults.up is not None:
            peer_reaches &= faults.up[targets][:, None]
        reached = peer_reaches.any(dim=1)
        errs = (~peer_ok).sum(dim=1)
        inconclusive = errs == params.ping_req_size
        declare_suspect = probing & ~reached & ~inconclusive

        # suspect at the member's current incarnation (node.go:508)
        tgt_inc = state.incarnation[i_all, targets]
        cand_key = pack_key(tgt_inc, SUSPECT)
        suspect_cand = torch.full((n, n), -1, dtype=torch.int32, device=dev)
        suspect_cand[i_all, targets] = torch.where(declare_suspect, cand_key, -1)
        _apply_batch(params, state, suspect_cand, now)

    with record_function("timers"):
        # timers fire against sim time
        _fire_timers(params, state, now)

    return state._replace(tick=state.tick + 1, key=keys[0])


def as_fullview_faults(faults, device: DeviceLike = None) -> Faults:
    """Coerce a shared-harness ``delta.DeltaFaults`` (or this engine's own
    ``Faults``) into ``Faults`` on ``device`` (legs given as numpy arrays or
    tensors).  The rate stays a static Python number, so it must be a
    concrete one here.  Legs fullview cannot express are refused, as the
    JAX package refuses them."""
    if hasattr(faults, "at_tick"):
        raise TypeError(
            "the fullview oracle takes a static fault model, not a "
            "time-varying chaos.FaultPlan — evaluate it yourself at a "
            "fixed tick (chaos.faults_at(plan, t)) if that is what you "
            "mean"
        )
    if getattr(faults, "reach", None) is not None or getattr(faults, "drop_node", None) is not None:
        # refusing beats silently simulating a DIFFERENT fault model: the
        # oracle's connectivity is symmetric-group + scalar loss only
        raise ValueError(
            "fullview cannot express directed reach / per-node drop — "
            "those legs exist only in the delta/lifecycle engines"
        )
    if (
        getattr(faults, "tier_ids", None) is not None
        or getattr(faults, "suspect_ticks", None) is not None
    ):
        raise ValueError(
            "fullview cannot express topology tier legs or a traced "
            "suspect_ticks override — those exist only in the "
            "delta/lifecycle engines"
        )
    dev = None if device is None else torch.device(device)

    def leg(x, dtype):
        if x is None:
            return None
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return t.to(device=dev if dev is not None else t.device, dtype=dtype)

    rate = getattr(faults, "drop_rate", None)
    return Faults(
        up=leg(faults.up, torch.bool),
        group=leg(faults.group, torch.int32),
        drop_rate=0.0 if rate is None else float(rate),
    )


class FullViewSim:
    """Convenience wrapper: state on ``device`` (the card unless the caller
    asks for the CPU) and multi-tick runs.  Accepts this engine's
    ``Faults`` or a shared-harness ``delta.DeltaFaults`` (coerced via
    :func:`as_fullview_faults`)."""

    def __init__(self, n: int, seed: int = 0, converged: bool = True, device: DeviceLike = None, **kw):
        self.params = FullViewParams(n=n, **kw)
        self.state = init_state(self.params, seed=seed, converged=converged, device=device)

    @property
    def state(self) -> FullViewState:
        return self._state

    @state.setter
    def state(self, state: FullViewState) -> None:
        # the tick is read once here and counted on the host after, so a
        # tick needs no sync to check the incarnation limit
        self._state, self._tick = state, int(state.tick)

    @property
    def device(self) -> torch.device:
        return self.state.status.device

    def tick(self, faults: Faults = Faults(), targets=None, peers=None) -> FullViewState:
        now_ms = (self._tick + 1) * self.params.tick_ms
        if now_ms >= MAX_INCARNATION:
            raise OverflowError(
                f"tick {self._tick} would refute at incarnation {now_ms} ms, past the engine's limit "
                f"{MAX_INCARNATION} (a change key is (incarnation << {STATE_BITS}) | state in int32)")
        self._state = step(self.params, self.state, as_fullview_faults(faults, self.device), targets, peers)
        self._tick += 1
        return self.state

    def run(self, ticks: int, faults: Faults = Faults()) -> FullViewState:
        faults = as_fullview_faults(faults, self.device)
        for _ in range(ticks):
            self.tick(faults)
        return self.state

    # -- queries ------------------------------------------------------------

    def views_converged(self) -> bool:
        """All live nodes share an identical view (the sim analog of equal
        checksums)."""
        s = self.state
        return bool(
            (s.status == s.status[0][None, :]).all()
            & (s.incarnation == s.incarnation[0][None, :]).all()
            & (s.present == s.present[0][None, :]).all()
        )

    def status_matrix(self) -> np.ndarray:
        return self.state.status.cpu().numpy()

    def has_changes(self) -> bool:
        return bool(self.state.has_change.any())


# -- carrying a JAX state across ------------------------------------------------

_LEAF_DTYPES = {  # leaf -> (JAX numpy dtype, port torch dtype)
    "status": (np.int8, torch.int8),
    "incarnation": (np.int32, torch.int32),
    "present": (np.bool_, torch.bool),
    "has_change": (np.bool_, torch.bool),
    "pcount": (np.int32, torch.int32),
    "pending": (np.int8, torch.int8),
    "deadline": (np.int32, torch.int32),
    "tick": (np.int32, torch.int32),
    "key": (np.uint32, torch.int64),
}


def state_from_numpy(params: FullViewParams, arrays, device: DeviceLike = None) -> FullViewState:
    """A ``FullViewState`` on ``device`` from the JAX package's leaves (a
    JAX ``FullViewState`` or any sequence in its field order, as
    numpy-convertible arrays); the uint32 key crosses as int64."""
    dev = resolve_device(device)
    n = params.n
    out = []
    for name, leaf in zip(FullViewState._fields, arrays, strict=True):
        np_dtype, dtype = _LEAF_DTYPES[name]
        arr = np.asarray(leaf).astype(np_dtype, copy=False)
        want = (n, n) if name in PLANES else () if name == "tick" else (2,)
        if arr.shape != want:
            raise ValueError(f"{name}: shape {arr.shape}, want {want} for n = {n}")
        out.append(torch.as_tensor(np.array(arr, dtype=np.int64 if dtype == torch.int64 else np_dtype), device=dev))
    return FullViewState(*out)


def state_to_numpy(state: FullViewState) -> FullViewState:
    """The leaves as numpy arrays of the JAX package's dtypes (uint32 key)."""
    return FullViewState(*(
        leaf.detach().cpu().numpy().astype(_LEAF_DTYPES[name][0])
        for name, leaf in zip(FullViewState._fields, state)))
