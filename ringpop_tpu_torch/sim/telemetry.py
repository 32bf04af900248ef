"""Device-resident telemetry plane for the sim engines.

Counterpart of ``ringpop_tpu/sim/telemetry.py``, record for record: cheap
per-tick counters carried on the device through the tick loop and fetched
in blocks, so observability costs no host round trip a tick.

* **Bit-identity.** Telemetry only reads intermediates the protocol tick
  already computes: it consumes no draw and writes nothing back, so a
  telemetry-on run is bit-identical to a telemetry-off one.
* **None costs nothing.** Every seam (``lifecycle.step``, ``_run_block``,
  the ``run_until_*`` drivers) takes ``telemetry=None`` by default, and
  the None leg launches exactly what it launched before telemetry existed.
* **Accumulators shaped like their sources** ([N] per-node masks, [N, W]
  packed planes, [K] slot vectors, [M] placement vectors), reduced to
  scalars once a block in :func:`fetch`.

On the card the tick's [N, W] and [N] legs are one launch of kernel P1 and
the state digest one launch of kernel D1 (``csrc/telemetry.cu``,
``ops/telemetry_kernel.py``); on the CPU their plain versions below run.
The accumulators are updated in place (the JAX package's are immutable):
:func:`accumulate` returns the same tensors, one tick further on.

The host half (journal, stats bridge, sink) is the JAX package's, with the
port's own toolchain fingerprint (torch, CUDA, numpy, Python).  Counter
overflow: int32 accumulators hold per-tick increments of at most N (or 32
per packed word); a fetch resets them.  :func:`fetch` reports the N·T-scaling
sums in float32, as the JAX package does; the port takes each sum exactly
in int64 and rounds once, so the two agree bit for bit while the true sum
is below 2**24 and to the last bits of float32 above it.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.ops import telemetry_kernel
from ringpop_tpu_torch.sim.delta import N_TIERS, TIER_NAMES, DeltaFaults, converged_fraction, resolve_faults
from ringpop_tpu_torch.sim.packbits import _POPCOUNT8, M32, mix32, n_words
from ringpop_tpu_torch.swim.member import ALIVE, FAULTY, SUSPECT, TOMBSTONE

# record-key suffixes for the per-tier counters ("same_rack", ...)
TIER_KEYS = tuple(name.replace("-", "_") for name in TIER_NAMES)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# elements a chunk of the plain digest takes (its int64 temporaries stay
# at 8 * _DIGEST_CHUNK bytes each, whatever the leaf's size)
_DIGEST_CHUNK = 1 << 24


class TelemetryState(NamedTuple):
    """Per-tick protocol counters, accumulated on the device between
    fetches; every leaf is an elementwise accumulator shaped like the mask
    it counts, and ``fetch`` owns the reduction to scalars."""

    # per-node masks — [N]
    pings: torch.Tensor  # int32[N]: completed direct probe exchanges
    ping_reqs: torch.Tensor  # int32[N]: indirect probe legs issued
    probes_failed: torch.Tensor  # int32[N]: direct probes that found no path
    incarnation_bumps: torch.Tensor  # int32[N]: refutations that placed
    # packed-plane event counts — [N, W], int32 holding uint32
    piggybacked: torch.Tensor  # rumor bits ridden (both legs)
    expired: torch.Tensor  # piggyback gates closed (maxP hit)
    # rumor-table vectors — [K]
    timer_fires: torch.Tensor  # int32[K]: in-flight-rumor state-timer transitions completed
    base_timer_fires: torch.Tensor  # int32[N]: folded-to-base state-timer transitions completed
    # placement vectors — [M], M = alloc budget
    decl_alive: torch.Tensor  # int32[M]: refutation rumors placed
    decl_suspect: torch.Tensor  # int32[M]: suspect declarations placed
    decl_faulty: torch.Tensor  # int32[M]: faulty declarations placed
    decl_tombstone: torch.Tensor  # int32[M]: tombstone (leave) declarations
    # scalars
    heal_attempts: torch.Tensor  # int32[]: partition-healer pair swaps tried
    ticks: torch.Tensor  # int32[]: ticks accumulated since the last fetch
    # optional per-tier suspicion flow (topology plane): None unless armed
    # with ``zeros(params, tiers=True)``
    suspects_by_tier: Optional[torch.Tensor] = None  # int32[N, 4]: declarations by tier
    false_suspects_by_tier: Optional[torch.Tensor] = None  # int32[N, 4]: target was live


def placement_budget(params) -> int:
    """M, the per-tick rumor-allocation budget (the ``m`` of
    ``lifecycle.step``)."""
    return min(params.alloc_per_tick, params.k, params.n)


def zeros(params, tiers: bool = False, device: DeviceLike = None) -> TelemetryState:
    """A zeroed accumulator for a ``LifecycleParams`` config on ``device``
    (the card unless the caller asks for the CPU).  ``tiers`` arms the
    per-tier suspicion counters (topology runs)."""
    dev = resolve_device(device)
    n, k = params.n, params.k
    m = placement_budget(params)
    i32 = dict(dtype=torch.int32, device=dev)
    tier_kw = (
        {"suspects_by_tier": torch.zeros((n, N_TIERS), **i32),
         "false_suspects_by_tier": torch.zeros((n, N_TIERS), **i32)}
        if tiers else {}
    )
    return TelemetryState(
        **tier_kw,
        pings=torch.zeros((n,), **i32),
        ping_reqs=torch.zeros((n,), **i32),
        probes_failed=torch.zeros((n,), **i32),
        incarnation_bumps=torch.zeros((n,), **i32),
        piggybacked=torch.zeros((n, n_words(k)), **i32),
        expired=torch.zeros((n, n_words(k)), **i32),
        timer_fires=torch.zeros((k,), **i32),
        base_timer_fires=torch.zeros((n,), **i32),
        decl_alive=torch.zeros((m,), **i32),
        decl_suspect=torch.zeros((m,), **i32),
        decl_faulty=torch.zeros((m,), **i32),
        decl_tombstone=torch.zeros((m,), **i32),
        heal_attempts=torch.zeros((), **i32),
        ticks=torch.zeros((), **i32),
    )


def _popcount_words(p: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> int32[..., W]: each word's set bits (a byte table)."""
    byts = p.contiguous().view(torch.uint8).to(torch.int64)
    return _POPCOUNT8.to(p.device)[byts].view(*p.shape, 4).sum(dim=-1, dtype=torch.int32)


def accumulate_plain(acc: dict, *, sent_w, resp_w, ride_ok, mid_ride_w, delivered, probing, peer_ok, refute,
                     placed, base_fired) -> None:
    """The plain version of P1 (``ops.telemetry_kernel.accumulate_cuda``):
    the [N, W] and [N] legs of one tick, in place."""
    acc["piggybacked"] += _popcount_words(sent_w) + _popcount_words(resp_w)
    acc["expired"] += _popcount_words(ride_ok & ~mid_ride_w)
    acc["pings"] += delivered
    acc["ping_reqs"] += torch.where(probing, peer_ok.sum(dim=1, dtype=torch.int32), 0)
    acc["probes_failed"] += probing
    acc["incarnation_bumps"] += refute & placed
    acc["base_timer_fires"] += base_fired


def accumulate(
    tel: TelemetryState,
    *,
    delivered: torch.Tensor,  # bool[N]
    probing: torch.Tensor,  # bool[N]
    peer_ok: torch.Tensor,  # bool[N, P]: indirect legs that could be issued
    refute: torch.Tensor,  # bool[N]
    placed: torch.Tensor,  # bool[N]: the node's refutation rumor placed
    sent_w: torch.Tensor,  # int32[N, W]
    resp_w: torch.Tensor,  # int32[N, W]
    ride_ok: torch.Tensor,  # int32[N, W]: the tick-entry gate
    mid_ride_w: torch.Tensor,  # int32[N, W]: the gate after the bump
    fired: torch.Tensor,  # bool[K]
    base_fired: torch.Tensor,  # bool[N]
    place: torch.Tensor,  # bool[M]
    new_status: torch.Tensor,  # int8[M]
    heal_attempt: Optional[torch.Tensor],  # bool[] or None (healer disabled)
    declared: Optional[torch.Tensor] = None,  # bool[N] suspicion declarers (placed)
    declared_tier: Optional[torch.Tensor] = None,  # int32[N] accuser→target tier
    declared_up: Optional[torch.Tensor] = None,  # bool[N] target live per the plan
) -> TelemetryState:
    """One tick's counter updates, in place; returns ``tel``.  The JAX
    package's ``accumulate`` with its derived inputs taken apart, so that
    P1 forms them itself: ``ping_req_legs`` is ``where(probing,
    peer_ok.sum(1), 0)``, ``refuted`` is ``refute & placed`` and
    ``closed_w`` is ``ride_ok & ~mid_ride_w``.  The [N, W] and [N] legs run
    on P1 on the card (one launch); the [K], [M] and scalar legs and the
    tier one-hot are plain PyTorch."""
    acc = {name: getattr(tel, name) for name in (
        "piggybacked", "expired", "pings", "ping_reqs", "probes_failed", "incarnation_bumps", "base_timer_fires")}
    legs = dict(sent_w=sent_w, resp_w=resp_w, ride_ok=ride_ok, mid_ride_w=mid_ride_w, delivered=delivered,
                probing=probing, peer_ok=peer_ok, refute=refute, placed=placed, base_fired=base_fired)
    if tel.piggybacked.device.type == "cpu":
        accumulate_plain(acc, **legs)
    else:
        telemetry_kernel.accumulate_cuda(acc, **legs)
    if tel.suspects_by_tier is not None and declared is not None:
        tiers = torch.arange(N_TIERS, dtype=torch.int32, device=declared.device)
        onehot = declared[:, None] & (declared_tier[:, None] == tiers[None, :])
        tel.suspects_by_tier.add_(onehot)
        tel.false_suspects_by_tier.add_(onehot & declared_up[:, None])
    tel.timer_fires.add_(fired)
    for name, status in (("decl_alive", ALIVE), ("decl_suspect", SUSPECT), ("decl_faulty", FAULTY),
                         ("decl_tombstone", TOMBSTONE)):
        getattr(tel, name).add_(place & (new_status == status))
    if heal_attempt is not None:
        tel.heal_attempts.add_(heal_attempt)
    tel.ticks.add_(1)
    return tel


# -- fetch: the once-per-block reduction + census ----------------------------


def _f32_sum(x: torch.Tensor) -> torch.Tensor:
    """The float32 of ``x``'s exact sum (int64), rounded once."""
    return x.sum(dtype=torch.int64).to(torch.float32)


def _u32_sum(p: torch.Tensor) -> torch.Tensor:
    """The float32 sum of a plane of int32 holding uint32."""
    return _f32_sum(p.to(torch.int64) & M32)


def _census(state, faults: DeltaFaults) -> dict:
    """Point-in-time membership census from the converged base view, plus
    the detection fraction over the fault model's down nodes."""
    present = state.base_present
    status = state.base_status

    def count(s):
        return (present & (status == s)).sum(dtype=torch.int32)

    out = {
        "num_members": present.sum(dtype=torch.int32),
        "census_alive": count(ALIVE),
        "census_suspect": count(SUSPECT),
        "census_faulty": count(FAULTY),
        "census_tombstone": count(TOMBSTONE),
        "rumors_active": (state.r_subject >= 0).sum(dtype=torch.int32),
    }
    one = torch.ones((), dtype=torch.float32, device=present.device)
    if faults.up is not None:
        down = ~faults.up
        detected = down & (~present | (status >= FAULTY))
        down_total = _f32_sum(down)
        # an empty down set reports the vacuous 1.0 (a fully recovered
        # cluster under a time-varying plan), as the up-is-None branch does
        out["detect_frac"] = torch.where(down_total > 0, _f32_sum(detected) / down_total.clamp_min(1.0), one)
    else:
        out["detect_frac"] = one
    return out


def fetch(tel: TelemetryState, state, faults: DeltaFaults = DeltaFaults()) -> tuple[dict, TelemetryState]:
    """Reduce the block's accumulators to a scalar record and reset them.
    Returns ``(record, zeroed_tel)``: a flat dict of 0-d tensors on the
    device (``_to_host`` brings them over in one copy).  A time-varying
    plan is resolved at the state's tick; the directed-partition
    attribution reads the unresolved plan's group/reach, which are
    time-invariant."""
    raw_group = getattr(faults, "group", None)
    raw_reach = getattr(faults, "reach", None)
    faults = resolve_faults(faults, state.tick)
    record = {
        "ticks": tel.ticks,
        "ping_send": _f32_sum(tel.pings),
        "ping_req_send": _f32_sum(tel.ping_reqs),
        "ping_timeout": _f32_sum(tel.probes_failed),
        "refuted": _f32_sum(tel.incarnation_bumps),
        "rumors_piggybacked": _u32_sum(tel.piggybacked),
        "rumors_expired": _u32_sum(tel.expired),
        # the JAX package adds the [K] and [N] float32 sums
        "timer_fired": _f32_sum(tel.timer_fires) + _f32_sum(tel.base_timer_fires),
        "decl_alive": tel.decl_alive.sum(dtype=torch.int32),
        "decl_suspect": tel.decl_suspect.sum(dtype=torch.int32),
        "decl_faulty": tel.decl_faulty.sum(dtype=torch.int32),
        "decl_tombstone": tel.decl_tombstone.sum(dtype=torch.int32),
        "heal_attempts": tel.heal_attempts,
        "tick": state.tick,
    }
    if tel.suspects_by_tier is not None:
        s = tel.suspects_by_tier.sum(dim=0, dtype=torch.int64).to(torch.float32)
        fpos = tel.false_suspects_by_tier.sum(dim=0, dtype=torch.int64).to(torch.float32)
        for ti, key in enumerate(TIER_KEYS):
            record[f"suspects_{key}"] = s[ti]
            record[f"false_suspects_{key}"] = fpos[ti]
    if raw_group is not None and raw_reach is not None:
        # directed-partition attribution: the block's refutations split by
        # whether the refuting subject's group g sits in the unreachable
        # direction of a one-way window (some group a cannot send to g
        # while g can send to a); a symmetric partition reports zero there
        reach_b = torch.as_tensor(raw_reach, device=tel.pings.device).to(torch.bool)
        one_way = ~reach_b & reach_b.transpose(-1, -2)
        blocked = one_way.any(dim=-2)  # [G]
        g = torch.as_tensor(raw_group, device=tel.pings.device).to(torch.int64)
        flag = (g >= 0) & blocked[g.clamp_min(0)]
        bumps = tel.incarnation_bumps
        record["refuted_unreachable_dir"] = _f32_sum(torch.where(flag, bumps, 0))
        record["refuted_reachable_dir"] = _f32_sum(torch.where(~flag, bumps, 0))
    record.update(_census(state, faults))
    fresh = TelemetryState(*(None if x is None else torch.zeros_like(x) for x in tel))
    return record, fresh


def split_batched(record: dict, extra: Optional[dict] = None, id_base: int = 0) -> list[dict]:
    """Split one batched block record (every value ``[B]``-leading) into B
    per-scenario host records, each tagged ``scenario_id`` (offset by
    ``id_base``).  ``extra`` merges additional ``[B]`` columns before the
    split; scalars broadcast to every record."""
    host = {k: _host_value(v) for k, v in {**record, **(extra or {})}.items()}
    b = max((np.asarray(v).shape[0] for v in host.values() if np.ndim(v) >= 1), default=1)
    out = []
    for i in range(b):
        sliced = {k: (np.asarray(v)[i] if np.ndim(v) >= 1 else v) for k, v in host.items()}
        out.append({"scenario_id": id_base + i, **_to_host(sliced)})
    return out


# -- order-sensitive state digest (journal pairing) --------------------------


def _leaf_list(tree) -> list:
    """The leaves of a state in the JAX package's pytree order: NamedTuple and
    tuple fields in order, dict values by sorted key, None skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaf_list(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in _leaf_list(sub)]
    raise TypeError(f"tree_digest takes tensors, tuples, lists and dicts, got {type(tree).__name__}")


def leaf_digest_sum_plain(leaf: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """The plain version of D1's leaf sum: the wrapping uint32 sum of
    ``mix32(value ^ mix32(offset + flat index))`` over the elements, as a
    0-d int64 holding the uint32.  The value is the element as uint32 (a
    bool 0/1, an int8 sign-extended as JAX's ``astype(uint32)`` does, int32
    planes as their bits, the int64 key by its low word); the flat index of
    a contiguous [rows, rowlen] leaf is JAX's ``row * rowlen + col``, mod
    2**32.  Taken in chunks of ``_DIGEST_CHUNK`` elements."""
    flat = leaf.reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=leaf.device)
    for lo in range(0, flat.shape[0], _DIGEST_CHUNK):
        v = flat[lo:lo + _DIGEST_CHUNK].to(torch.int64) & M32
        idx = (torch.arange(lo, lo + v.shape[0], dtype=torch.int64, device=leaf.device) + offset) & M32
        total = (total + (mix32(v ^ mix32(idx))).sum()) & M32
    return total


def leaf_digest_sum(leaf: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """0-d int64 holding uint32: one leaf's inner digest sum, the flat
    index starting at ``offset`` (a block at its global offset gives an
    exact partial of the whole leaf's sum).  D1 on a CUDA tensor."""
    leaf = torch.as_tensor(leaf)
    if leaf.device.type == "cpu":
        return leaf_digest_sum_plain(leaf, offset)
    return telemetry_kernel.state_digest_cuda([leaf], offset=offset, final=False)


def tree_digest_plain(tree) -> torch.Tensor:
    """The plain version of D1's tree digest."""
    leaves = _leaf_list(tree)
    dev = leaves[0].device if leaves else torch.device("cpu")
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for li, leaf in enumerate(leaves):
        acc = acc + mix32(leaf_digest_sum_plain(leaf) ^ ((li * 0x9E37_79B9) & M32))
    return acc & M32


def tree_digest(tree) -> torch.Tensor:
    """0-d int64 holding uint32, on the state's device: a position-sensitive
    digest of every leaf of an integer/bool state (both engines' states
    qualify): the wrapping sum over leaves ``li`` of ``mix32(leaf sum ^ li *
    0x9E3779B9)``.  Two states digest equal iff every leaf is bit-equal (up
    to hash collision).  One launch of D1 (after a zero fill) on the card."""
    leaves = _leaf_list(tree)
    if not leaves or leaves[0].device.type == "cpu":
        return tree_digest_plain(tree)
    return telemetry_kernel.state_digest_cuda(leaves)


def delta_record(state, faults: DeltaFaults = DeltaFaults()) -> dict:
    """The delta engine's per-block journal record (0-d tensors): coverage
    fraction and the state digest, its convergence series."""
    return {
        "tick": state.tick,
        "coverage": converged_fraction(state, faults),
        "digest": tree_digest(state),
    }


# -- toolchain / mesh-budget fingerprints ------------------------------------


def toolchain_fingerprint() -> dict:
    """The versions that decide whether two captures are comparable: the
    port's torch and CUDA in place of the JAX package's jax and jaxlib."""
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "python": ".".join(map(str, sys.version_info[:3])),
    }


def mesh_budget_fingerprint(repo: str = _REPO) -> dict:
    """Identity of the collective-budget baseline a journal names
    (``captures/mesh_profile_small_budget.json``): file name and content
    sha256 prefix.  Missing capture → ``{"budget_capture": None}``."""
    path = os.path.join(repo, "captures", "mesh_profile_small_budget.json")
    if not os.path.exists(path):
        return {"budget_capture": None}
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return {"budget_capture": os.path.basename(path), "sha256": digest}


def _host_value(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def _to_host(record: dict) -> dict:
    """Every value of a record as a host JSON scalar: the tensors come over
    in one copy per dtype, numpy scalars are coerced, floats are rounded to
    6 places (so the journal, the stats bridge and ``TelemetrySink.records``
    carry the same numbers).  Idempotent on host dicts."""
    tensors = {k: v for k, v in record.items() if isinstance(v, torch.Tensor) and v.dim() == 0}
    fetched = {}
    by_dtype: dict = {}
    for k, v in tensors.items():
        by_dtype.setdefault((v.dtype, v.device), []).append(k)
    for (dtype, _), keys in by_dtype.items():
        values = torch.stack([tensors[k] for k in keys]).cpu().numpy()
        fetched.update(zip(keys, values))
    host = {}
    for k, v in record.items():
        v = fetched[k] if k in fetched else _host_value(v)
        if isinstance(v, (np.generic, np.ndarray)):
            v = v.item() if np.ndim(v) == 0 else np.asarray(v).tolist()
        if isinstance(v, float):
            v = round(v, 6)
        host[k] = v
    return host


# -- JSONL run journal -------------------------------------------------------


class TelemetryJournal:
    """One JSONL stream per run: a ``header`` record (engine, params,
    toolchain and mesh-budget fingerprints), then one ``block`` record per
    fetched tick block (and a ``score`` record per chaos scenario).
    Context manager; safe to hand to several scenarios in append mode."""

    def __init__(self, path: str, *, append: bool = False):
        self.path = path
        self._f = open(path, "a" if append else "w", buffering=1)

    def header(self, engine: str, scenario: str = "", params: Optional[dict] = None) -> None:
        from ringpop_tpu_torch.obs.flight import git_commit

        # which rank of which job size wrote the stream: 1/0 unless a
        # torch.distributed group is up
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            pc, pid = dist.get_world_size(), dist.get_rank()
        else:
            pc, pid = 1, 0
        self._write({
            "kind": "header",
            "engine": engine,
            "scenario": scenario,
            "params": params or {},
            "toolchain": toolchain_fingerprint(),
            "git_commit": git_commit(),
            "mesh_budget": mesh_budget_fingerprint(),
            # the port keeps no persistent compile cache: its kernels are
            # built once a checkout into _build/, keyed by their source (an
            # AOT warm start is ROADMAP A15)
            "compile_cache": {"cache_dir": None, "error": None, "persistent": False},
            "process_count": pc,
            "process_id": pid,
        })

    def block(self, record: dict, **extra) -> None:
        self._write({"kind": "block", **_to_host({**record, **extra})})

    def score(self, record: dict) -> None:
        """Append a chaos-scenario verdict (``chaos.score_blocks``)."""
        self._write({**_to_host(record), "kind": "score"})

    def span(self, record: dict) -> None:
        """Append one ``kind: "span"`` record (host scalars)."""
        self._write({**record, "kind": "span"})

    def _write(self, obj: dict) -> None:
        self._f.write(json.dumps(obj, sort_keys=True) + "\n")

    def close(self) -> None:
        self._f.flush()
        self._f.close()

    def __enter__(self) -> "TelemetryJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_journal(path: str) -> list[dict]:
    """Parse a JSONL journal back into records."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- event bus + StatsReporter bridge ----------------------------------------

SIM_STAT_PREFIX = "ringpop.sim"

# record field -> (statsd method, key suffix), the host plane's vocabulary
# (OBSERVABILITY.md's key table)
STAT_KEYS = {
    "ping_send": ("incr", "ping.send"),
    "ping_req_send": ("incr", "ping-req.send"),
    "ping_timeout": ("incr", "ping.timeout"),
    "refuted": ("incr", "refuted-update"),
    "rumors_piggybacked": ("incr", "changes.disseminate"),
    "rumors_expired": ("incr", "changes.expired"),
    "timer_fired": ("incr", "state-timer.fired"),
    "decl_alive": ("incr", "membership-update.alive"),
    "decl_suspect": ("incr", "membership-update.suspect"),
    "decl_faulty": ("incr", "membership-update.faulty"),
    "decl_tombstone": ("incr", "membership-update.tombstone"),
    "heal_attempts": ("incr", "heal.attempt"),
    "num_members": ("gauge", "num-members"),
    "census_alive": ("gauge", "membership.alive"),
    "census_suspect": ("gauge", "membership.suspect"),
    "census_faulty": ("gauge", "membership.faulty"),
    "census_tombstone": ("gauge", "membership.tombstone"),
    "rumors_active": ("gauge", "rumors.active"),
    "detect_frac": ("gauge", "detection.fraction"),
}

# topology-plane block keys (tier-armed topology runs), under ringpop.sim.topo.*
for _tk, _dash in zip(TIER_KEYS, TIER_NAMES):
    STAT_KEYS[f"suspects_{_tk}"] = ("incr", f"topo.suspects.{_dash}")
    STAT_KEYS[f"false_suspects_{_tk}"] = ("incr", f"topo.false-suspects.{_dash}")
STAT_KEYS["refuted_unreachable_dir"] = ("incr", "topo.refuted.unreachable-dir")
STAT_KEYS["refuted_reachable_dir"] = ("incr", "topo.refuted.reachable-dir")


def emit_stats(reporter, record: dict, prefix: str = SIM_STAT_PREFIX) -> None:
    """Feed a fetched block record into a ``StatsReporter``
    (``options.py``) under the sim namespace."""
    record = _to_host(record)
    for field, (kind, suffix) in STAT_KEYS.items():
        if field not in record:
            continue
        if kind == "incr":
            reporter.incr(f"{prefix}.{suffix}", int(record[field]))
        else:
            reporter.gauge(f"{prefix}.{suffix}", float(record[field]))


class TelemetrySink:
    """Fan a fetched block record out to any of: a JSONL journal, a
    ``StatsReporter``, an event emitter (``events.EventEmitter``, as a
    ``SimTickBlockEvent``) and a plain callable — the one object
    ``LifecycleSim`` and ``DeltaSim`` attach."""

    def __init__(
        self,
        journal: Optional[TelemetryJournal] = None,
        stats=None,
        emitter=None,
        fn: Optional[Callable[[dict], None]] = None,
        stat_prefix: str = SIM_STAT_PREFIX,
    ):
        self.journal = journal
        self.stats = stats
        self.emitter = emitter
        self.fn = fn
        self.stat_prefix = stat_prefix
        self.records: list = []  # host-side history (cheap; per block)

    def __call__(self, record: dict, **extra: Any) -> None:
        host = _to_host({**record, **extra})
        self.records.append(host)
        if self.journal is not None:
            self.journal.block(host)
        if self.stats is not None:
            emit_stats(self.stats, host, self.stat_prefix)
        if self.emitter is not None:
            from ringpop_tpu_torch.events import SimTickBlockEvent

            self.emitter.emit(SimTickBlockEvent(record=host))
        if self.fn is not None:
            self.fn(host)


# -- carrying a JAX accumulator across ------------------------------------------


def telemetry_from_numpy(leaves, device: DeviceLike = None) -> TelemetryState:
    """A ``TelemetryState`` on ``device`` from the JAX package's (any
    object with its field names, or a sequence in its field order, as
    numpy-convertible arrays; None legs stay None): the uint32 planes cross
    as their int32 bit pattern."""
    dev = resolve_device(device)
    if not hasattr(leaves, "_fields"):
        leaves = dict(zip(TelemetryState._fields, leaves))
    else:
        leaves = leaves._asdict()
    out = {}
    for name in TelemetryState._fields:
        leaf = leaves.get(name)
        if leaf is None:
            out[name] = None
            continue
        arr = np.asarray(leaf)
        arr = arr.astype(np.uint32).view(np.int32) if name in ("piggybacked", "expired") else arr.astype(np.int32)
        out[name] = torch.as_tensor(np.array(arr), device=dev)
    return TelemetryState(**out)
