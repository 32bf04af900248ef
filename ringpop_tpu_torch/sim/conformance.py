"""Lockstep conformance: sequential reference semantics vs the vectorized sim.

Counterpart of ``ringpop_tpu/sim/conformance.py``, line for line, with the
same numpy draws.  The BASELINE gate is *bit-identical member states versus
the sequential reference semantics* — this module provides both halves:

* :class:`SequentialSwim` — a per-node, change-at-a-time interpreter of the
  SWIM update rules (the same override/refutation/precedence rules the host
  plane runs, parity ``swim/memberlist.go:310-390``), with dict member
  tables per node exactly like the reference's ``memberlist.members`` map.
  No arrays, no vectorization: every phase is plain Python loops applying
  one candidate change at a time.  Its ``maxP`` takes the vectorized
  engine's integer digit count (``fullview.decimal_digits``), where the
  JAX package evaluates the float32 expression through ``jnp``; the two
  agree for every count.
* :class:`LockstepRunner` — drives :class:`SequentialSwim` and
  ``fullview.FullViewSim`` (on the card unless ``device`` says otherwise)
  through the *same* injected per-tick randomness (ping targets, ping-req
  peers, fault masks) and asserts the full protocol state is identical:
  membership views (status + incarnation + presence), dissemination
  records (change set + piggyback counters), and suspicion timers (pending
  transition + deadline).

Why this works: change application is a join-semilattice max over
``(incarnation, state-precedence)`` (``member.go:79-128``), so applying a
candidate batch max-merged (vectorized) and applying the same candidates
one-at-a-time in any order (sequential reference) reach the same state.
The harness proves the vectorized engine implements exactly that —
including the side-effect paths that do NOT commute trivially:
refutation-by-reincarnation, timer schedule/cancel/dedup, full-sync +
reverse full-sync, piggyback expiry, and the evict path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike
from ringpop_tpu_torch.sim.fullview import (
    STATE_BITS,
    Faults,
    FullViewParams,
    FullViewSim,
    decimal_digits,
    state_to_numpy,
)
from ringpop_tpu_torch.swim.member import ALIVE, FAULTY, LEAVE, SUSPECT, TOMBSTONE

_DETRACTIONS = (SUSPECT, FAULTY, TOMBSTONE)


def _host(x) -> np.ndarray:
    """A fault leg (numpy array or tensor) as a host numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _key(inc: int, status: int) -> int:
    return (int(inc) << STATE_BITS) | int(status)


@dataclass
class _NodeState:
    """One node's protocol state, reference-shaped: maps keyed by member."""

    view: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # j -> (status, inc)
    changes: Dict[int, int] = field(default_factory=dict)  # j -> pcount
    pending: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # j -> (state, deadline)


class SequentialSwim:
    """Sequential-semantics SWIM cluster interpreter (the reference oracle)."""

    def __init__(self, params: FullViewParams, converged: bool = True):
        self.params = params
        self.tick_no = 0
        n = params.n
        self.nodes = [_NodeState() for _ in range(n)]
        for i in range(n):
            if converged:
                self.nodes[i].view = {j: (ALIVE, 0) for j in range(n)}
            else:
                self.nodes[i].view = {i: (ALIVE, 0)}

    # -- scalar update pipeline (memberlist.Update per candidate) -----------

    def _timeout_for(self, st: int) -> int:
        p = self.params
        return {SUSPECT: p.suspect_ticks, FAULTY: p.faulty_ticks, TOMBSTONE: p.tombstone_ticks}[st]

    def _apply(self, r: int, j: int, cinc: int, cst: int, now_ms: int) -> None:
        """Apply one candidate change about member ``j`` at node ``r``
        (parity: ``memberlist.go:310-390`` + ``node.go:424-445``)."""
        node = self.nodes[r]
        local = node.view.get(j)
        refute = (
            r == j
            and cst in _DETRACTIONS
            and local is not None
            and cinc >= local[1]
        )
        if refute:
            node.view[r] = (ALIVE, now_ms)
            applied = True
        else:
            local_eff = _key(local[1], local[0]) if local is not None else -1
            wins = _key(cinc, cst) > local_eff
            if wins and local is None and cst == TOMBSTONE:
                wins = False  # first-seen tombstones refused (memberlist.go:421-426)
            if wins:
                node.view[j] = (cst, cinc)
            applied = wins
        if not applied:
            return
        node.changes[j] = 0  # RecordChange (node.go:425-427)
        eff_st = node.view[j][0]
        if eff_st in (ALIVE, LEAVE):
            node.pending.pop(j, None)  # Cancel (node.go:431)
        elif j != r:
            prev = node.pending.get(j)
            if prev is None or prev[0] != eff_st:  # same-state dedup
                node.pending[j] = (eff_st, self.tick_no + self._timeout_for(eff_st))

    def _apply_batch(self, batches: Dict[int, Dict[int, Tuple[int, int]]], now_ms: int) -> None:
        """Apply per-receiver candidate sets collected from one snapshot."""
        for r, cands in batches.items():
            for j, (cinc, cst) in cands.items():
                self._apply(r, j, cinc, cst, now_ms)

    # -- one protocol period -------------------------------------------------

    def step(
        self,
        targets: np.ndarray,
        peers: np.ndarray,
        faults: Optional[Faults] = None,
    ) -> None:
        p = self.params
        n = p.n
        now_ms = (self.tick_no + 1) * p.tick_ms
        up = _host(faults.up) if faults is not None and faults.up is not None else np.ones(n, bool)
        group = _host(faults.group) if faults is not None and faults.group is not None else None

        def connected(a: int, b: int) -> bool:
            if not (up[a] and up[b]):
                return False
            if group is not None and group[a] >= 0 and group[b] >= 0 and group[a] != group[b]:
                return False
            return True

        pingable: List[set] = [
            {
                j
                for j, (st, _) in self.nodes[i].view.items()
                if j != i and st in (ALIVE, SUSPECT)
            }
            for i in range(n)
        ]
        any_pingable = [bool(s) for s in pingable]
        delivered = [
            any_pingable[i] and up[i] and connected(i, int(targets[i])) for i in range(n)
        ]

        # maxP per node — the vectorized engine's integer digit count
        num = np.array([len(s) for s in pingable], np.int32)
        max_p = (p.p_factor * decimal_digits(num)).astype(np.int32)

        # -- request leg: senders' unexpired changes, delivered to targets
        send_mask: Dict[int, List[int]] = {}
        inbound: Dict[int, Dict[int, Tuple[int, int]]] = {}
        for i in range(n):
            if not delivered[i]:
                continue
            t = int(targets[i])
            sends = [j for j, pc in self.nodes[i].changes.items() if pc < max_p[i]]
            send_mask[i] = sends
            dst = inbound.setdefault(t, {})
            for j in sends:
                st, inc = self.nodes[i].view[j]
                prev = dst.get(j)
                if prev is None or _key(inc, st) > _key(prev[0], prev[1]):
                    dst[j] = (inc, st)
        self._apply_batch(inbound, now_ms)

        # -- full-sync detection (post-request-leg state)
        full_sync = [False] * n
        for i in range(n):
            if not delivered[i]:
                continue
            t = int(targets[i])
            has_any_t = bool(self.nodes[t].changes)
            full_sync[i] = (not has_any_t) and (self.nodes[i].view != self.nodes[t].view)

        # -- response leg: target's changes (full membership on full sync)
        responses: Dict[int, Dict[int, Tuple[int, int]]] = {}
        for i in range(n):
            if not delivered[i]:
                continue
            t = int(targets[i])
            tn = self.nodes[t]
            if full_sync[i]:
                cand = {j: (inc, st) for j, (st, inc) in tn.view.items()}
            else:
                cand = {
                    j: (tn.view[j][1], tn.view[j][0])
                    for j, pc in tn.changes.items()
                    if pc < max_p[t]
                }
            responses[i] = cand
        self._apply_batch(responses, now_ms)

        # -- reverse full sync: target pulls the sender's membership
        rfs: Dict[int, Dict[int, Tuple[int, int]]] = {}
        for i in range(n):
            if not (full_sync[i] and delivered[i]):
                continue
            t = int(targets[i])
            dst = rfs.setdefault(t, {})
            for j, (st, inc) in self.nodes[i].view.items():
                prev = dst.get(j)
                if prev is None or _key(inc, st) > _key(prev[0], prev[1]):
                    dst[j] = (inc, st)
        self._apply_batch(rfs, now_ms)

        # -- piggyback bumps + expiry
        got_pinged = [False] * n
        for i in range(n):
            if delivered[i]:
                got_pinged[int(targets[i])] = True
        for i in range(n):
            node = self.nodes[i]
            bumps: Dict[int, int] = {}
            for j in send_mask.get(i, ()):
                if j in node.changes:
                    bumps[j] = bumps.get(j, 0) + 1
            if got_pinged[i]:
                for j, pc in node.changes.items():
                    if pc < max_p[i]:
                        bumps[j] = bumps.get(j, 0) + 1
            for j, b in bumps.items():
                node.changes[j] += b
            for j in [j for j, pc in node.changes.items() if pc >= max_p[i]]:
                del node.changes[j]

        # -- failed direct probe → indirect ping-req → Suspect
        suspects: Dict[int, Dict[int, Tuple[int, int]]] = {}
        for i in range(n):
            if not (any_pingable[i] and up[i] and not delivered[i]):
                continue
            t = int(targets[i])
            pool = pingable[i] - {t}
            ok_ct = 0
            reached = False
            for pr in peers[i]:
                pr = int(pr)
                peer_ok = pr in pool and connected(i, pr)
                if peer_ok:
                    ok_ct += 1
                    if connected(pr, t) and up[t]:
                        reached = True
            if ok_ct == 0:  # all errors → inconclusive (node.go:497-503)
                continue
            if reached:
                continue
            cur = self.nodes[i].view.get(t)
            if cur is None:
                continue
            suspects[i] = {t: (cur[1], SUSPECT)}
        self._apply_batch(suspects, now_ms)

        # -- timers fire against sim time (state_transitions.go:90-117)
        fire: List[Tuple[int, int, int]] = []
        for i in range(n):
            for j, (src_st, deadline) in list(self.nodes[i].pending.items()):
                if self.tick_no >= deadline:
                    fire.append((i, j, src_st))
                    del self.nodes[i].pending[j]
        transitions: Dict[int, Dict[int, Tuple[int, int]]] = {}
        evictions: List[Tuple[int, int]] = []
        for i, j, src_st in fire:
            if src_st == TOMBSTONE:
                evictions.append((i, j))
                continue
            nxt = FAULTY if src_st == SUSPECT else TOMBSTONE
            cur = self.nodes[i].view.get(j)
            if cur is None:
                continue
            transitions.setdefault(i, {})[j] = (cur[1], nxt)
        self._apply_batch(transitions, now_ms)
        for i, j in evictions:
            self.nodes[i].view.pop(j, None)
            self.nodes[i].changes.pop(j, None)

        self.tick_no += 1

    # -- array export for comparison ----------------------------------------

    def as_arrays(self):
        n = self.params.n
        status = np.zeros((n, n), np.int8)
        inc = np.zeros((n, n), np.int32)
        present = np.zeros((n, n), bool)
        has_change = np.zeros((n, n), bool)
        pcount = np.zeros((n, n), np.int32)
        pending = np.full((n, n), -1, np.int8)
        deadline = np.zeros((n, n), np.int32)
        for i, node in enumerate(self.nodes):
            for j, (st, ic) in node.view.items():
                present[i, j] = True
                status[i, j] = st
                inc[i, j] = ic
            for j, pc in node.changes.items():
                has_change[i, j] = True
                pcount[i, j] = pc
            for j, (st, dl) in node.pending.items():
                pending[i, j] = st
                deadline[i, j] = dl
        return status, inc, present, has_change, pcount, pending, deadline


class LockstepRunner:
    """Drive the sequential oracle and the vectorized engine in lockstep."""

    def __init__(self, n: int, seed: int = 0, converged: bool = True, device: DeviceLike = None, **param_kw):
        self.params = FullViewParams(n=n, **param_kw)
        self.seq = SequentialSwim(self.params, converged=converged)
        self.vec = FullViewSim(n=n, seed=seed, converged=converged, device=device, **param_kw)
        self.rng = np.random.default_rng(seed)

    def draw(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-tick randomness from the oracle's pingable sets — both engines
        receive identical targets/peers (the reference's shuffled round-robin
        and random peer draw, made injectable)."""
        n = self.params.n
        targets = np.zeros(n, np.int32)
        peers = np.zeros((n, self.params.ping_req_size), np.int32)
        for i in range(n):
            pool = sorted(
                j
                for j, (st, _) in self.seq.nodes[i].view.items()
                if j != i and st in (ALIVE, SUSPECT)
            )
            if pool:
                targets[i] = self.rng.choice(pool)
                ppool = [j for j in pool if j != targets[i]] or pool
                peers[i] = self.rng.choice(ppool, size=self.params.ping_req_size)
            else:
                targets[i] = (i + 1) % n
                peers[i] = (i + 1) % n
        return targets, peers

    def tick(self, faults: Faults = Faults()) -> None:
        targets, peers = self.draw()
        self.seq.step(targets, peers, faults)
        dev = self.vec.device
        self.vec.tick(faults, targets=torch.as_tensor(targets, device=dev),
                      peers=torch.as_tensor(peers, device=dev))

    def assert_identical(self) -> None:
        """Bit-identical protocol state across both engines."""
        status, inc, present, has_change, pcount, pending, deadline = self.seq.as_arrays()
        v_status, v_inc, v_present, v_has, v_pcount, v_pending, v_deadline = state_to_numpy(self.vec.state)[:7]

        def _diff(name, a, b, mask=None):
            if mask is not None:
                a = np.where(mask, a, 0)
                b = np.where(mask, b, 0)
            if not (a == b).all():
                idx = np.argwhere(a != b)[:8]
                raise AssertionError(
                    f"tick {self.seq.tick_no}: {name} diverged at cells "
                    f"{idx.tolist()}: seq={a[tuple(idx[0])]} vec={b[tuple(idx[0])]}"
                )

        _diff("present", present, v_present)
        _diff("status", status, v_status, present)
        _diff("incarnation", inc, v_inc, present)
        _diff("has_change", has_change, v_has)
        _diff("pcount", pcount, v_pcount, has_change)
        _diff("pending", pending, v_pending)
        _diff("deadline", deadline, v_deadline, pending >= 0)

    def run(self, ticks: int, faults: Faults = Faults(), check_every: int = 1) -> None:
        for k in range(ticks):
            self.tick(faults)
            if (k + 1) % check_every == 0:
                self.assert_identical()
