"""Partition healing (parity: reference ``swim/heal_partition.go`` +
``swim/heal_via_discover_provider.go``).

``attempt_heal``: join the target to fetch its membership; any node that
would become unpingable after merging either view is first reincarnated by
disseminating Suspect declarations to both sides; once views are mergeable,
merge by applying B locally and pinging our membership over to B.

``DiscoverProviderHealer``: background loop attempting heals every ``period``
with probability ``base_prob / cluster_size`` (~6 provider calls/min
cluster-wide at defaults, ``swim/node.go:59-67``).

Counterpart of ``ringpop_tpu/swim/heal.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import asyncio
import random
from typing import Optional

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch.swim import events as ev
from ringpop_tpu_torch.swim.member import FAULTY, SUSPECT, Change
from ringpop_tpu_torch.swim.join import send_join_request
from ringpop_tpu_torch.swim.ping import send_ping_with_changes

# reference defaults (swim/node.go:59-67)
DEFAULT_HEAL_PERIOD = 30.0
DEFAULT_HEAL_BASE_PROBABILITY = 3.0
HEAL_JOIN_TIMEOUT = 1.0
MAX_HEAL_FAILURES = 10


def _select_member(changes: list[Change], address: str) -> Optional[Change]:
    for c in changes:
        if c.address == address:
            return c
    return None


def nodes_that_need_to_reincarnate(
    ma: list[Change], mb: list[Change]
) -> tuple[list[Change], list[Change]]:
    """Find nodes that would become unpingable when merging either way
    (parity: ``heal_partition.go:64-92``)."""
    changes_for_a: list[Change] = []
    changes_for_b: list[Change] = []
    for b in mb:
        a = _select_member(ma, b.address)
        if a is None:
            continue
        if b.is_pingable and a.overrides(b) and not a.is_pingable:
            changes_for_b.append(Change(address=a.address, incarnation=a.incarnation, status=SUSPECT))
        if a.is_pingable and b.overrides(a) and not b.is_pingable:
            changes_for_a.append(Change(address=b.address, incarnation=b.incarnation, status=SUSPECT))
    return changes_for_a, changes_for_b


def pingable_hosts(changes: list[Change]) -> list[str]:
    return [c.address for c in changes if c.is_pingable]


async def attempt_heal(node, target: str) -> list[str]:
    """(parity: ``heal_partition.go:33-59`` AttemptHeal)"""
    node.emit(ev.AttemptHealEvent())
    node.logger.info("attempt heal with %s", target)

    join_res = await send_join_request(node, target, HEAL_JOIN_TIMEOUT)
    ma = node.disseminator.membership_as_changes()
    mb = join_res.membership

    changes_for_a, changes_for_b = nodes_that_need_to_reincarnate(ma, mb)

    if changes_for_a or changes_for_b:
        # reincarnate first; the heal completes on a later attempt
        node.memberlist.update(changes_for_a)
        if changes_for_b:
            await send_ping_with_changes(node, target, changes_for_b, HEAL_JOIN_TIMEOUT)
        return pingable_hosts(mb)

    # mergeable: apply B locally, push A to B
    node.memberlist.update(mb)
    ma = node.disseminator.membership_as_changes()
    await send_ping_with_changes(node, target, ma, HEAL_JOIN_TIMEOUT)
    return pingable_hosts(mb)


class DiscoverProviderHealer:
    """(parity: ``heal_via_discover_provider.go``)"""

    def __init__(
        self,
        node,
        period: float = DEFAULT_HEAL_PERIOD,
        base_probability: float = DEFAULT_HEAL_BASE_PROBABILITY,
        rng: Optional[random.Random] = None,
    ):
        self.node = node
        self.period = period
        self.base_probability = base_probability
        self.previous_host_list_size = 0
        self.rng = rng or random.Random()
        self._task: Optional[asyncio.Task] = None
        self.logger = logging_mod.logger("healer").with_field("local", node.address)

    def probability(self) -> float:
        """(parity: ``heal_via_discover_provider.go:104-113``)"""
        size = max(
            self.previous_host_list_size, self.node.memberlist.count_reachable_members(), 1
        )
        self.previous_host_list_size = size
        return self.base_probability / size

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        try:
            while True:
                if self.rng.random() < self.probability():
                    await self.heal()
                await asyncio.sleep(self.period)
        except asyncio.CancelledError:
            pass

    async def heal(self) -> list[str]:
        """Attempt heals against provider hosts that are faulty-or-unknown
        locally (parity: ``heal_via_discover_provider.go:120-177``)."""
        self.node.emit(ev.DiscoHealEvent())
        provider = self.node.discover_provider
        if provider is None:
            return []
        try:
            host_list = provider.hosts()
        except Exception as e:
            self.logger.warn("healer could not get hosts: %s", e)
            return []

        self.previous_host_list_size = len(host_list)
        targets = []
        for address in host_list:
            m = self.node.memberlist.member(address)
            if m is None or m.status >= FAULTY:
                targets.append(address)
        self.rng.shuffle(targets)

        healed: list[str] = []
        failures = 0
        while targets and failures < MAX_HEAL_FAILURES:
            target = targets.pop(0)
            try:
                other_side = await attempt_heal(self.node, target)
            except Exception as e:
                self.logger.warn("heal attempt failed: %s", e)
                failures += 1
                continue
            targets = [t for t in targets if t not in other_side]
            healed.append(target)
        if failures >= MAX_HEAL_FAILURES:
            self.logger.warn("healer reached max failures")
        return healed
