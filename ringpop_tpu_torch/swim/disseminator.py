"""Piggyback change dissemination (parity: reference ``swim/disseminator.go``).

Changes ride on every ping/ping-req/ack until each has been propagated
``max_p = p_factor * ceil(log10(n_pingable + 1))`` times — the SWIM paper's
dissemination bound (``disseminator.go:75-97``).  Sender issuance bumps
counters only on delivery success (via callback); receiver issuance bumps
immediately because acks can't be confirmed (``disseminator.go:128-181``).
When there is nothing to piggyback but checksums disagree, the receiver
answers with its whole membership (full sync) and may pull the sender's view
through a bounded reverse-full-sync worker pool (``disseminator.go:257-304``).

Counterpart of ``ringpop_tpu/swim/disseminator.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import asyncio
import math
from typing import Callable, Optional

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch.swim import events as ev
from ringpop_tpu_torch.swim.member import Change, member_to_change

DEFAULT_P_FACTOR = 15


class PChange:
    __slots__ = ("change", "p")

    def __init__(self, change: Change, p: int = 0):
        self.change = change
        self.p = p


class Disseminator:
    def __init__(self, node, p_factor: int = DEFAULT_P_FACTOR, max_reverse_full_sync_jobs: int = 5):
        self.node = node
        self.changes: dict[str, PChange] = {}
        self.p_factor = p_factor
        self.max_p = p_factor
        self.max_reverse_full_sync_jobs = max_reverse_full_sync_jobs
        self._reverse_full_sync_jobs = 0
        self.logger = logging_mod.logger("disseminator").with_field("local", node.address)

    # -- dissemination bound (parity: disseminator.go:75-97) ----------------

    def adjust_max_propagations(self) -> None:
        num_pingable = self.node.memberlist.num_pingable_members()
        new_max_p = self.p_factor * math.ceil(math.log10(num_pingable + 1))
        if new_max_p != self.max_p:
            self.node.emit(ev.MaxPAdjustedEvent(self.max_p, new_max_p))
            self.max_p = new_max_p

    # -- issuance -----------------------------------------------------------

    def has_changes(self) -> bool:
        return bool(self.changes)

    def changes_count(self) -> int:
        return len(self.changes)

    def changes_by_address(self, address: str) -> Optional[Change]:
        pc = self.changes.get(address)
        return pc.change if pc else None

    def membership_as_changes(self) -> list[Change]:
        """Entire membership as changes, for joins and full syncs
        (parity: ``disseminator.go:107-123``)."""
        return [
            member_to_change(m, self.node.address, self.node.incarnation())
            for m in self.node.memberlist.get_members()
        ]

    def issue_changes(self) -> list[Change]:
        result = [pc.change for pc in self.changes.values()]
        self.node.emit(ev.ChangesCalculatedEvent(result))
        return result

    def issue_as_sender(self) -> tuple[list[Change], Callable[[], None]]:
        """Changes for an outgoing ping/ping-req + a callback that bumps the
        piggyback counters — called only when the send succeeded
        (parity: ``disseminator.go:128-133``)."""
        changes = self.issue_changes()
        return changes, lambda: self.bump_piggyback_counters(changes)

    def issue_as_receiver(
        self, sender_address: str, sender_incarnation: int, sender_checksum: int
    ) -> tuple[list[Change], bool]:
        """Changes for a ping/ping-req response; counters bump immediately.
        Returns (changes, full_sync_triggered)
        (parity: ``disseminator.go:156-181``)."""
        changes = self.issue_changes()
        changes = self._filter_changes_from_sender(changes, sender_address, sender_incarnation)
        self.bump_piggyback_counters(changes)

        if changes or self.node.memberlist.checksum() == sender_checksum:
            return changes, False

        self.node.emit(ev.FullSyncEvent(sender_address, sender_checksum))
        self.logger.info("full sync with %s", sender_address)
        return self.membership_as_changes(), True

    def _filter_changes_from_sender(
        self, changes: list[Change], source: str, incarnation: int
    ) -> list[Change]:
        """Don't echo changes back to their source
        (parity: ``disseminator.go:185-199``)."""
        out = []
        for c in changes:
            if c.source == source and c.source_incarnation == incarnation:
                self.node.emit(ev.ChangeFilteredEvent(c))
            else:
                out.append(c)
        return out

    def bump_piggyback_counters(self, changes: list[Change]) -> None:
        for change in changes:
            pc = self.changes.get(change.address)
            if pc is None:
                continue
            pc.p += 1
            if pc.p >= self.max_p:
                del self.changes[change.address]

    # -- recording ----------------------------------------------------------

    def record_change(self, change: Change) -> None:
        self.changes[change.address] = PChange(change, 0)

    def clear_change(self, address: str) -> None:
        self.changes.pop(address, None)

    def clear_changes(self) -> None:
        self.changes.clear()

    # -- reverse full sync (parity: disseminator.go:257-304) ----------------

    def try_start_reverse_full_sync(self, target: str, timeout: float) -> Optional[asyncio.Task]:
        if self._reverse_full_sync_jobs >= self.max_reverse_full_sync_jobs:
            self.logger.info("omit reverse full sync with %s: pool exhausted", target)
            self.node.emit(ev.OmitReverseFullSyncEvent(target))
            return None
        self._reverse_full_sync_jobs += 1
        task = asyncio.ensure_future(self._reverse_full_sync_job(target, timeout))
        return task

    async def _reverse_full_sync_job(self, target: str, timeout: float) -> None:
        try:
            await self.reverse_full_sync(target, timeout)
        finally:
            self._reverse_full_sync_jobs -= 1

    async def reverse_full_sync(self, target: str, timeout: float) -> None:
        """Pull the target's membership through a join request and merge it —
        heals asymmetric divergence (parity: ``disseminator.go:283-304``)."""
        from ringpop_tpu_torch.swim.join import send_join_request

        self.node.emit(ev.StartReverseFullSyncEvent(target))
        try:
            res = await send_join_request(self.node, target, timeout)
        except Exception as e:
            self.logger.warn("reverse full sync join request failed: %s", e)
            return
        applied = self.node.memberlist.update(res.membership)
        if not applied:
            self.node.emit(ev.RedundantReverseFullSyncEvent(target))
