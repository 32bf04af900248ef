"""DGRO-style token placement: diameter/spread-guided, churn-scored.

Counterpart of ``ringpop_tpu/serve/placement.py``.  DGRO (PAPERS.md, arxiv
2410.11142) optimizes ring memberships by diameter-guided search over
candidate orderings; the analog for a consistent-hash ring is TOKEN
PLACEMENT: the reference's random replica points (``farm32(addr + i)``)
leave both large uncovered arcs (the ring "diameter" — the largest token
gap, which one owner's load scales with) and load imbalance.  This pass
scores a small family of candidate placements as ONE batched device
computation and picks the best — guided by diameter and spread, gated by
the same key-movement-under-churn metric the ``ring1m`` churn-rebalance
harness measures, so a candidate can never win by sacrificing the
consistent-hashing property the ring exists for.

Candidate family: per-(server, replica) re-mixes ``mix32(base ^ salt_c)``
of the default farm tokens, PLUS diameter-guided LOCAL MOVES: for each move
count ``m`` in ``local_moves``, the tokens adjacent to the ``m`` SMALLEST
arcs relocate to the midpoints of the ``m`` LARGEST arcs.  A move is
recorded as a sticky (server address, replica index) → token OVERRIDE
chosen once at scoring time and replayed VERBATIM on later membership
changes, so a surviving server's tokens never move under a fixed candidate
(a dead server's overrides vanish with its tokens).  Candidate 0 is the
UNMODIFIED default placement.  Scores per candidate, all on the device:

* ``movement`` — fraction of probe keys whose owner changes when a churn
  cohort is removed (the ring1m rebalance metric).
* ``excess`` — moved keys whose OLD owner survived the churn: nonzero
  means the placement broke consistent hashing.
* ``imbalance`` — max/mean owner load over the probe set.
* ``diameter`` — largest uncovered arc (max token gap incl. wraparound),
  as a fraction of the hash space.

Selection: among candidates whose ``movement`` does not exceed candidate
0's, minimize ``imbalance`` then ``diameter``.  Opt-in:
``RingStore(placement="dgro")``; the default serving path never runs it.

The JAX package's ``jax.vmap`` over candidates is here batched torch ops
over a ``[C, T]`` token tensor (int64 holding uint32): a stable sort along
T, a batched ``searchsorted(side="left")``, a float32 ``scatter_add_`` for
the loads and a plain max for the gaps.  The float32 arithmetic follows
what XLA compiles the JAX scorer's ``mean`` and division by a constant
into: the integer count times the float32 reciprocal of the probe count,
and ``imbalance`` as ``max_load * (float32(S) * reciprocal)`` — a division
``count / P`` differs in the last bit when P is not a power of two.  The
local moves, the overrides and the composite order stay numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.hashing import ring_tokens
from ringpop_tpu_torch.ops.ring_ops import ring_composite_order, ring_lookup
from ringpop_tpu_torch.sim.packbits import mix32

_SALT_STRIDE = np.uint32(0x9E37_79B9)
_M32 = 0xFFFF_FFFF


def _candidate_tokens(base: torch.Tensor, salt: int) -> torch.Tensor:
    """int64[T] (uint32 values) tokens of one candidate: salt 0 = the
    default placement, else a full-avalanche re-mix keyed on (base token,
    salt) only."""
    return base if salt == 0 else mix32(base ^ salt)


def _score_candidates(cand_tokens: torch.Tensor, owners: torch.Tensor, probes: torch.Tensor,
                      cohort: torch.Tensor):
    """Per-candidate (movement, excess, imbalance, diameter), float32[C]
    each — one batched pass over the candidate axis, on the inputs' device.

    cand_tokens: int64[C, T] candidate token values (uint32) in the flat
    owner-major, replica-minor layout; owners: int64[T]; probes: int64[P]
    (uint32 values); cohort: bool[S] — servers removed by the churn probe.
    """
    c, t = cand_tokens.shape
    n_servers = int(cohort.shape[0])
    n_probes = int(probes.shape[0])
    dev = cand_tokens.device
    # XLA's constant reciprocal (see the module docstring)
    recip = np.float32(1.0) / np.float32(n_probes)
    per_probe = torch.tensor(float(recip), dtype=torch.float32, device=dev)
    per_load = torch.tensor(float(np.float32(n_servers) * recip), dtype=torch.float32, device=dev)
    keys = probes.reshape(1, n_probes).expand(c, n_probes).contiguous()

    # stable sort == the host composite (token, owner) order: the flat
    # layout is owner-ascending, so ties keep owner order
    st, order = torch.sort(cand_tokens, dim=1, stable=True)
    so = owners[order]

    def lookup(sorted_toks, sorted_owners, live_t):
        idx = torch.searchsorted(sorted_toks, keys, side="left")
        idx = torch.where(idx >= live_t, 0, idx)
        return sorted_owners.gather(1, idx)

    before = lookup(st, so, t)  # [C, P]
    # churn: push the cohort's tokens past the live region and re-sort (a
    # live token equal to 0xFFFFFFFF keeps its place ahead of them)
    dead = cohort[so]
    toks_after = torch.where(dead, _M32, st)
    st2, order2 = torch.sort(toks_after, dim=1, stable=True)
    so2 = so.gather(1, order2)
    live_t = t - dead.sum(dim=1, keepdim=True)
    after = lookup(st2, so2, live_t)

    moved = before != after
    movement = moved.sum(dim=1).to(torch.float32) * per_probe
    excess = (moved & ~cohort[before]).sum(dim=1).to(torch.float32) * per_probe
    loads = torch.zeros((c, n_servers), dtype=torch.float32, device=dev)
    loads.scatter_add_(1, before, torch.ones(before.shape, dtype=torch.float32, device=dev))
    imbalance = loads.amax(dim=1) * per_load
    if t > 1:
        gaps = st[:, 1:] - st[:, :-1]
        # uint32 arithmetic: a ring with a token at 0 wraps to its own value
        wrap = (st[:, 0] + (_M32 - st[:, -1]) + 1) & _M32
        diameter = torch.maximum(gaps.amax(dim=1), wrap).to(torch.float32) / float(2.0**32)
    else:  # a single token owns the whole ring
        diameter = torch.ones(c, dtype=torch.float32, device=dev)
    return movement, excess, imbalance, diameter


def _flat_tokens(base: np.ndarray, salt: int) -> np.ndarray:
    """Host copy of one salt candidate's tokens in the flat layout."""
    toks = _candidate_tokens(torch.from_numpy(base.astype(np.int64)), int(salt))
    return toks.numpy().astype(np.uint32)


def _apply_moves(flat: np.ndarray, owners: np.ndarray, m: int):
    """Diameter-guided local moves on one candidate's flat tokens: the
    tokens bounding the ``m`` smallest arcs move to the midpoints of the
    ``m`` largest arcs.  Returns (new flat tokens, overrides) where
    overrides maps FLAT index -> new token value — the caller re-keys by
    (server, replica) identity for sticky replay."""
    t = flat.shape[0]
    m = int(min(m, max(t // 2 - 1, 0)))
    if m == 0:
        return flat, {}
    order = ring_composite_order(flat, owners)
    st = flat[order]
    gaps = np.empty(t, np.uint64)  # gap i: arc ABOVE sorted token i
    gaps[:-1] = st[1:].astype(np.uint64) - st[:-1].astype(np.uint64)
    gaps[-1] = (np.uint64(1 << 32) + st[0].astype(np.uint64)
                - st[-1].astype(np.uint64))
    big = np.argsort(gaps, kind="stable")[-m:]          # arcs to fill
    small = np.argsort(gaps, kind="stable")[: 2 * m]    # donor pool
    # donors: the token CLOSING each small arc (its own arc is tiny, so
    # relocating it moves the least key mass) — skipping any donor that
    # bounds a chosen large arc
    banned = set(big.tolist()) | {int((b + 1) % t) for b in big}
    donors = [int((s + 1) % t) for s in small if int((s + 1) % t) not in banned]
    donors = donors[:m]
    out = flat.copy()
    overrides = {}
    for d_sorted, g in zip(donors, sorted(big.tolist(), key=lambda i: -int(gaps[i]))):
        mid = (st[g].astype(np.uint64) + gaps[g] // np.uint64(2)) & np.uint64(
            0xFFFFFFFF
        )
        fi = int(order[d_sorted])  # back to the flat (server, replica) slot
        out[fi] = np.uint32(mid)
        overrides[fi] = int(mid)
    return out, overrides


def _materialize_flat(flat: np.ndarray, owners: np.ndarray):
    """(sorted tokens, sorted owners) of one candidate's flat tokens — the
    host composite (token, owner) collision order
    (``ring_ops.ring_composite_order``, the one shared rule)."""
    order = ring_composite_order(flat, owners)
    return flat[order].astype(np.uint32), owners[order].astype(np.int32)


def _apply_overrides(
    flat: np.ndarray, servers: list[str], replica_points: int, moves: dict
) -> np.ndarray:
    """Replay sticky ``(server, replica) -> token`` overrides onto the flat
    token layout of the CURRENT server set — overrides of departed servers
    vanish with their tokens, surviving ones keep their exact values (zero
    replay movement by construction)."""
    if not moves:
        return flat
    index = {srv: i for i, srv in enumerate(servers)}
    out = flat.copy()
    for (srv, rep), tok in moves.items():
        i = index.get(srv)
        if i is not None and 0 <= rep < replica_points:
            out[i * replica_points + rep] = np.uint32(tok)
    return out


def dgro_place(
    servers: list[str],
    replica_points: int,
    *,
    candidates: int = 8,
    local_moves: tuple = (1, 2, 4, 8),
    probes: int = 1 << 15,
    churn_frac: float = 0.01,
    seed: int = 0,
    fixed_salt: int | None = None,
    fixed_moves: dict | None = None,
    device: DeviceLike = None,
):
    """(tokens uint32[T], owners int32[T], report) — the DGRO pass, scored
    on ``device`` (the card by default).

    ``fixed_salt``/``fixed_moves`` replay a previously chosen candidate
    without re-scoring — the sticky mode ``RingStore`` uses after its first
    placement so membership churn never flips candidates mid-flight.
    ``local_moves`` widens the family with diameter-guided local token
    moves on top of the default placement (``()`` restores the salt-only
    family).
    """
    dev = resolve_device(device)
    s = len(servers)
    base = ring_tokens(servers, replica_points).reshape(-1).astype(np.uint32)
    owners_np = np.repeat(np.arange(s, dtype=np.int32), replica_points)
    if fixed_salt is not None:
        flat = _flat_tokens(base, fixed_salt)
        flat = _apply_overrides(flat, servers, replica_points, fixed_moves or {})
        st, so = _materialize_flat(flat, owners_np)
        return (
            st,
            so,
            {
                "salt": int(fixed_salt),
                "moves": dict(fixed_moves or {}),
                "rescored": False,
            },
        )
    rng = np.random.default_rng(seed)
    salt_arr = (np.arange(candidates, dtype=np.uint64) * _SALT_STRIDE).astype(
        np.uint32
    )
    # the family: salt re-mixes (candidate 0 = the reference placement),
    # then diameter-guided local-move variants of the DEFAULT placement
    family: list[dict] = [{"salt": int(v), "moves": {}} for v in salt_arr]
    flats = [_flat_tokens(base, int(v)) for v in salt_arr]
    base_flat = flats[0]
    for mcount in local_moves:
        moved, ov = _apply_moves(base_flat, owners_np, int(mcount))
        if not ov:
            continue
        flats.append(moved)
        family.append(
            {
                "salt": 0,
                "moves": {
                    (servers[fi // replica_points], fi % replica_points): tok
                    for fi, tok in ov.items()
                },
                "local_moves": int(mcount),
            }
        )
    probe_arr = rng.integers(0, 2**32, size=probes, dtype=np.uint32)
    m = max(1, int(round(churn_frac * s))) if s > 1 else 0
    cohort = np.zeros(s, bool)
    if m:
        cohort[rng.choice(s, size=m, replace=False)] = True
    movement, excess, imbalance, diameter = (
        a.cpu().numpy()
        for a in _score_candidates(
            torch.from_numpy(np.stack(flats).astype(np.int64)).to(dev),
            torch.from_numpy(owners_np.astype(np.int64)).to(dev),
            torch.from_numpy(probe_arr.astype(np.int64)).to(dev),
            torch.from_numpy(cohort).to(dev),
        )
    )
    # the gate: never worse than random (candidate 0) on churn movement;
    # then diameter/spread-guided among the eligible
    eligible = movement <= movement[0] + 1e-9
    score = np.where(eligible, imbalance + diameter, np.inf)
    chosen = int(np.argmin(score))
    st, so = _materialize_flat(flats[chosen], owners_np)
    report = {
        "chosen": chosen,
        "salt": family[chosen]["salt"],
        "moves": family[chosen]["moves"],
        "local_moves": family[chosen].get("local_moves", 0),
        "family": len(family),
        "rescored": True,
        "candidates": candidates,
        "move_candidates": len(family) - candidates,
        "probes": probes,
        "churn_cohort": int(m),
        "movement": [round(float(v), 6) for v in movement],
        "excess_movement": [round(float(v), 6) for v in excess],
        "imbalance": [round(float(v), 4) for v in imbalance],
        "diameter": [round(float(v), 6) for v in diameter],
        "movement_random": round(float(movement[0]), 6),
        "movement_chosen": round(float(movement[chosen]), 6),
        "imbalance_random": round(float(imbalance[0]), 4),
        "imbalance_chosen": round(float(imbalance[chosen]), 4),
        "diameter_random": round(float(diameter[0]), 6),
        "diameter_chosen": round(float(diameter[chosen]), 6),
    }
    return st, so, report


def key_movement(
    tokens_a, owners_a, servers_a: list[str],
    tokens_b, owners_b, servers_b: list[str],
    hashes,
    device: DeviceLike = None,
) -> dict:
    """Key movement between two ring snapshots over a probe hash batch —
    the ring1m churn-rebalance metric, shared with the DGRO scorer; the
    lookups run on ``device`` (the card by default).

    Owner ids are matched ACROSS snapshots through the server lists (ids
    renumber on membership change), so ``moved`` counts real ownership
    transfers.  ``excess_moved`` is the consistent-hashing violation count:
    keys that moved between two servers present in BOTH snapshots (always
    0 for identity-keyed token placement)."""
    dev = resolve_device(device)

    def owners_of(tokens, owners):
        t = torch.from_numpy(np.asarray(tokens).astype(np.int64)).to(dev)
        o = torch.from_numpy(np.asarray(owners, np.int32)).to(dev)
        h = torch.from_numpy(np.asarray(hashes).astype(np.uint32).astype(np.int64)).to(dev)
        return ring_lookup(t, o, h).cpu().numpy()

    oa = owners_of(tokens_a, owners_a)
    ob = owners_of(tokens_b, owners_b)
    index_a = {srv: i for i, srv in enumerate(servers_a)}
    # b-id -> a-id (or -1 for servers new in b)
    b_to_a = np.array([index_a.get(srv, -1) for srv in servers_b], np.int64)
    survivors_a = np.zeros(len(servers_a), bool)
    survivors_a[b_to_a[b_to_a >= 0]] = True
    ob_in_a = b_to_a[ob]
    moved = ob_in_a != oa
    excess = moved & survivors_a[oa] & (ob_in_a >= 0)
    return {
        "probes": int(oa.shape[0]),
        "moved_frac": round(float(moved.mean()), 6),
        "excess_moved": int(excess.sum()),
        "removed_load_frac": round(float((~survivors_a[oa]).mean()), 6),
    }
