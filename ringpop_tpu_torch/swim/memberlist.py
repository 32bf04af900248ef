"""Authoritative member table (parity: reference ``swim/memberlist.go``).

Holds the update/override pipeline — the consistency core of SWIM
(``memberlist.go:310-390``): first-seen changes apply wholesale, detractions
about the local node are refuted by reincarnation, everything else applies by
the (incarnation, state-precedence) override rule from the shared semantics
core.  Checksum is farm32 over the reference's exact canonical string
(``memberlist.go:106-128``) so host-plane checksums are wire-compatible.

Counterpart of ``ringpop_tpu/swim/memberlist.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import random
from typing import Optional

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch import util
from ringpop_tpu_torch.hashing import membership_checksum
from ringpop_tpu_torch.swim import events as ev
from ringpop_tpu_torch.swim.member import (
    ALIVE,
    FAULTY,
    LEAVE,
    SUSPECT,
    TOMBSTONE,
    Change,
    Member,
    state_name,
)


class Memberlist:
    def __init__(self, node, rng: Optional[random.Random] = None):
        self.node = node
        self.local: Optional[Member] = None
        self._members: list[Member] = []
        self._by_address: dict[str, Member] = {}
        self._checksum: int = 0
        self._rng = rng or random.Random()
        self.logger = logging_mod.logger("membership").with_field("local", node.address)
        self.compute_checksum()

    # -- queries ------------------------------------------------------------

    def member(self, address: str) -> Optional[Member]:
        return self._by_address.get(address)

    def member_at(self, i: int) -> Member:
        return self._members[i]

    def num_members(self) -> int:
        return len(self._members)

    def checksum(self) -> int:
        return self._checksum

    def pingable(self, m: Member) -> bool:
        """(parity: ``memberlist.go:180-184``)"""
        return m.address != self.node.address and m.is_pingable

    def num_pingable_members(self) -> int:
        return sum(1 for m in self._members if self.pingable(m))

    def random_pingable_members(self, n: int, excluding: set[str]) -> list[Member]:
        """n random pingable members (parity: ``memberlist.go:200-218``)."""
        candidates = [
            m for m in self._members if self.pingable(m) and m.address not in excluding
        ]
        self._rng.shuffle(candidates)
        return candidates[:n]

    def get_members(self) -> list[Member]:
        return [Member(m.address, m.status, m.incarnation) for m in self._members]

    def get_reachable_members(self) -> list[str]:
        return [m.address for m in self._members if m.is_reachable]

    def count_reachable_members(self) -> int:
        return sum(1 for m in self._members if m.is_reachable)

    # -- checksum (parity: memberlist.go:83-128) ----------------------------

    def _checksum_entries(self) -> list[str]:
        """Unsorted per-member canonical entries ``addr+status+incarnation``,
        tombstones excluded to avoid resurrecting them through full syncs."""
        return [
            f"{m.address}{state_name(m.status)}{m.incarnation}"
            for m in self._members
            if m.status != TOMBSTONE
        ]

    def gen_checksum_string(self) -> str:
        """Exact reference canonical form: sorted entries joined with ';'
        (trailing ';')."""
        return "".join(s + ";" for s in sorted(self._checksum_entries()))

    def compute_checksum(self) -> int:
        old = self._checksum
        # the numpy farm copy over the sorted entries; bit-identical to
        # fingerprint32(self.gen_checksum_string())
        self._checksum = membership_checksum(self._checksum_entries())
        if self.node is not None:
            self.node.emit(
                ev.ChecksumComputeEvent(checksum=self._checksum, old_checksum=old)
            )
        return self._checksum

    # -- the update pipeline (parity: memberlist.go:310-390) ----------------

    def update(self, changes: list[Change]) -> list[Change]:
        if self.node.stopped() or not changes:
            return []

        self.node.emit(ev.MemberlistChangesReceivedEvent(list(changes)))
        applied: list[Change] = []

        for change in changes:
            member = self._by_address.get(change.address)

            # first time this member is seen: take the change wholesale
            if member is None:
                if self.apply(change):
                    applied.append(change)
                continue

            # a detraction about the local node: refute by reincarnation
            if member.local_override(self.node.address, change):
                self.node.emit(ev.RefuteUpdateEvent())
                new_inc = util.now_ms(self.node.clock)
                override = Change(
                    source=self.node.address,
                    source_incarnation=new_inc,
                    address=change.address,
                    incarnation=new_inc,
                    status=ALIVE,
                    timestamp=int(self.node.clock.now()),
                )
                if self.apply(override):
                    applied.append(override)
                continue

            # non-local override by (incarnation, precedence)
            if member.non_local_override(change):
                if self.apply(change):
                    applied.append(change)

        if applied:
            old = self._checksum
            self.compute_checksum()
            self.node.emit(
                ev.MemberlistChangesAppliedEvent(
                    changes=list(applied),
                    old_checksum=old,
                    new_checksum=self._checksum,
                    num_members=self.num_members(),
                )
            )
            self.node.handle_changes(applied)
            self.node.rollup.track_updates(applied)

        return applied

    def apply(self, change: Change) -> bool:
        """Insert-or-overwrite a member from a change
        (parity: ``memberlist.go:417-460`` Apply)."""
        member = self._by_address.get(change.address)
        if member is None:
            # never create a first-seen member directly as tombstone — it
            # would re-import evicted tombstones forever through full syncs
            # (parity: memberlist.go:421-426)
            if change.status == TOMBSTONE:
                return False
            member = Member(change.address, change.status, change.incarnation)
            pos = self._join_position()
            self._members.insert(pos, member)
            self._by_address[change.address] = member
            if change.address == self.node.address:
                self.local = member
            return True
        member.status = change.status
        member.incarnation = change.incarnation
        return True

    def _join_position(self) -> int:
        """Random insert position spreads iteration order
        (parity: ``memberlist.go:409-415``)."""
        l = len(self._members)
        return self._rng.randrange(l) if l else 0

    def add_join_list(self, join_list: list[Change]) -> list[Change]:
        """Apply a (possibly huge) join list but don't gossip it onward —
        clear all resulting dissemination except our own make-alive
        (parity: ``memberlist.go:398-406``)."""
        applied = self.update(join_list)
        for change in applied:
            if change.address == self.node.address:
                continue
            self.node.disseminator.clear_change(change.address)
        return applied

    def remove_member(self, address: str) -> bool:
        member = self._by_address.pop(address, None)
        if member is None:
            return False
        self._members.remove(member)
        self.compute_checksum()
        return True

    # -- declarations (parity: memberlist.go:231-300) -----------------------

    def reincarnate(self) -> list[Change]:
        """Self back to Alive at incarnation = now-ms
        (parity: ``memberlist.go:233-236``)."""
        return self.make_alive(self.node.address, util.now_ms(self.node.clock))

    def make_alive(self, address: str, incarnation: int) -> list[Change]:
        self.node.emit(ev.MakeNodeStatusEvent(ALIVE))
        return self.make_change(address, incarnation, ALIVE)

    def make_suspect(self, address: str, incarnation: int) -> list[Change]:
        self.node.emit(ev.MakeNodeStatusEvent(SUSPECT))
        return self.make_change(address, incarnation, SUSPECT)

    def make_faulty(self, address: str, incarnation: int) -> list[Change]:
        self.node.emit(ev.MakeNodeStatusEvent(FAULTY))
        return self.make_change(address, incarnation, FAULTY)

    def make_leave(self, address: str, incarnation: int) -> list[Change]:
        self.node.emit(ev.MakeNodeStatusEvent(LEAVE))
        return self.make_change(address, incarnation, LEAVE)

    def make_tombstone(self, address: str, incarnation: int) -> list[Change]:
        self.node.emit(ev.MakeNodeStatusEvent(TOMBSTONE))
        return self.make_change(address, incarnation, TOMBSTONE)

    def evict(self, address: str) -> None:
        """Remove a member; refuses the local node
        (parity: ``memberlist.go:271-279``)."""
        if address == self.node.address:
            self.logger.error("refusing to evict the local member")
            return
        self.remove_member(address)

    def make_change(self, address: str, incarnation: int, status: int) -> list[Change]:
        if self.local is None:
            # standalone identity only — NOT inserted into the table, so the
            # self change below flows through the first-seen path of update()
            # and is emitted/applied like any other (parity:
            # memberlist.go:433-446: Apply inserts and binds m.local)
            self.local = Member(self.node.address, ALIVE, util.now_ms(self.node.clock))
        return self.update(
            [
                Change(
                    source=self.local.address,
                    source_incarnation=self.local.incarnation,
                    address=address,
                    incarnation=incarnation,
                    status=status,
                    timestamp=int(self.node.clock.now()),
                )
            ]
        )
