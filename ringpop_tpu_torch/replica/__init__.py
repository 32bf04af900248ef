"""Quorum replication over LookupN preference lists
(parity: reference ``replica/replicator.go``).

``read``/``write`` fan a request out to the N owners of a key and succeed
when R/W responses arrive; fanout is Parallel, SerialSequential or
SerialBalanced (``replicator.go:40-52``).  N/R/W default to 3/1/3.

The serve plane's hash-batch analog is
``ringpop_tpu_torch.forward.batch.QuorumReader``: same
group-by-destination rule as :meth:`Replicator._group_replicas`, but
over uint32 hash batches with ONE coalesced RPC per owner per wave and
the majority bar ⌈(R+1)/2⌉.  Semantic changes to grouping or ack policy
should be mirrored between the two planes.

Counterpart of ``ringpop_tpu/replica/__init__.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import asyncio
import enum
import random
from dataclasses import dataclass, field
from typing import Any, Optional

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch import util
from ringpop_tpu_torch.forward import Forwarder
from ringpop_tpu_torch.forward.forwarder import Options as ForwardOptions


class FanoutMode(enum.IntEnum):
    PARALLEL = 0
    SERIAL_SEQUENTIAL = 1
    SERIAL_BALANCED = 2


@dataclass
class Options:
    """(parity: ``replicator.go:78-82``; zero selects defaults 3/1/3)"""

    n_value: int = 0
    r_value: int = 0
    w_value: int = 0
    fanout_mode: FanoutMode = FanoutMode.PARALLEL

    def merged_with(self, defaults: "Options") -> "Options":
        return Options(
            n_value=util.select_int(self.n_value, defaults.n_value),
            r_value=util.select_int(self.r_value, defaults.r_value),
            w_value=util.select_int(self.w_value, defaults.w_value),
            fanout_mode=self.fanout_mode
            if self.fanout_mode in tuple(FanoutMode)
            else FanoutMode.PARALLEL,
        )


DEFAULT_OPTIONS = Options(n_value=3, r_value=1, w_value=3, fanout_mode=FanoutMode.PARALLEL)


@dataclass
class Response:
    """(parity: ``replicator.go:71-76``)"""

    destination: str = ""
    keys: list[str] = field(default_factory=list)
    body: Any = None


class NotEnoughResponsesError(Exception):
    def __init__(self, wanted: int, got: int):
        super().__init__(f"wanted {wanted} responses, got {got}")
        self.wanted = wanted
        self.got = got


class Replicator:
    def __init__(self, sender, channel, options: Optional[Options] = None, rng=None):
        self.sender = sender
        self.channel = channel
        self.forwarder = Forwarder(sender, channel)
        self.defaults = (options or Options()).merged_with(DEFAULT_OPTIONS)
        self.rng = rng or random.Random()
        self.logger = logging_mod.logger("replicator")

    async def read(
        self,
        keys: list[str],
        body: dict,
        operation: str,
        fopts: Optional[ForwardOptions] = None,
        opts: Optional[Options] = None,
    ) -> list[Response]:
        opts = (opts or Options()).merged_with(self.defaults)
        return await self._read_write(keys, body, operation, fopts, opts, opts.r_value)

    async def write(
        self,
        keys: list[str],
        body: dict,
        operation: str,
        fopts: Optional[ForwardOptions] = None,
        opts: Optional[Options] = None,
    ) -> list[Response]:
        opts = (opts or Options()).merged_with(self.defaults)
        return await self._read_write(keys, body, operation, fopts, opts, opts.w_value)

    def _group_replicas(
        self, keys: list[str], n: int
    ) -> tuple[list[str], dict[str, list[str]]]:
        """Group keys by replica destination
        (parity: ``replicator.go:170-191`` groupReplicas)."""
        keys_by_dest: dict[str, list[str]] = {}
        dests: list[str] = []
        batch = getattr(self.sender, "lookup_n_batch", None)
        if batch is not None and len(keys) > 1:
            rows = batch(keys, n)  # one batched ring walk for all keys
        else:
            rows = [self.sender.lookup_n(key, n) for key in keys]
        for key, row in zip(keys, rows):
            for dest in row:
                if dest not in keys_by_dest:
                    dests.append(dest)
                keys_by_dest.setdefault(dest, []).append(key)
        return dests, keys_by_dest

    async def _read_write(
        self, keys, body, operation, fopts, opts, required: int
    ) -> list[Response]:
        """(parity: ``replicator.go:193-256`` readWrite)"""
        dests, keys_by_dest = self._group_replicas(keys, opts.n_value)
        if len(dests) < required:
            raise NotEnoughResponsesError(required, len(dests))

        fopts = fopts or ForwardOptions()

        async def call(dest: str) -> Response:
            res = await self.forwarder.forward_request(
                body, dest, self.channel.app or "replica", operation, keys_by_dest[dest], fopts
            )
            return Response(destination=dest, keys=keys_by_dest[dest], body=res)

        if opts.fanout_mode == FanoutMode.PARALLEL:
            results = await asyncio.gather(*(call(d) for d in dests), return_exceptions=True)
            responses = [r for r in results if isinstance(r, Response)]
        else:
            order = list(dests)
            if opts.fanout_mode == FanoutMode.SERIAL_BALANCED:
                self.rng.shuffle(order)
            responses = []
            for dest in order:
                try:
                    responses.append(await call(dest))
                except Exception:
                    continue
                if len(responses) >= required:
                    break

        if len(responses) < required:
            raise NotEnoughResponsesError(required, len(responses))
        return responses
