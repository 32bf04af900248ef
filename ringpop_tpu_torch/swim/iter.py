"""Ping-target iteration: shuffled round-robin with reshuffle each full pass
(parity: reference ``swim/memberlist_iter.go:50-72``) — gives SWIM's
bounded-staleness probe ordering.  The sim plane's analog is a per-node
permutation stream (``ringpop_tpu_torch.sim``).

Counterpart of ``ringpop_tpu/swim/iter.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import random
from typing import Optional

from ringpop_tpu_torch.swim.member import Member


class MemberlistIter:
    def __init__(self, memberlist, rng: Optional[random.Random] = None):
        self.memberlist = memberlist
        self._rng = rng or random.Random()
        self._index = -1
        self._ordering: list[str] = []

    def _reshuffle(self) -> None:
        self._ordering = [m.address for m in self.memberlist.get_members()]
        self._rng.shuffle(self._ordering)
        self._index = -1

    def next(self) -> Optional[Member]:
        """Next pingable member; gives up after a full pass without finding
        one (parity: ``memberlist_iter.go:50-72``)."""
        num_members = self.memberlist.num_members()
        visited = 0
        while visited < num_members + 1:
            self._index += 1
            if self._index >= len(self._ordering) or num_members != len(self._ordering):
                self._reshuffle()
                self._index = 0
                if not self._ordering:
                    return None
            member = self.memberlist.member(self._ordering[self._index])
            if member is not None and self.memberlist.pingable(member):
                return member
            visited += 1
        return None
