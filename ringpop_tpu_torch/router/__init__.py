"""Key→client routing cache (parity: reference ``router/router.go``).

``get_client(key)`` looks the key up on the ring and returns either the local
service implementation or a cached remote client for the owner; cached
clients are evicted when the owner becomes Faulty/Leave
(``router/router.go:70-84``).

Counterpart of ``ringpop_tpu/router/__init__.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import threading
from typing import Any, Protocol

from ringpop_tpu_torch.swim import events as swim_ev
from ringpop_tpu_torch.swim.member import FAULTY, LEAVE


class ClientFactory(Protocol):
    """(parity: ``router/router.go:47-54``)"""

    def get_local_client(self) -> Any: ...

    def make_remote_client(self, hostport: str) -> Any: ...


class Router:
    def __init__(self, ringpop, factory: ClientFactory, lookup_source=None):
        self.ringpop = ringpop
        self.factory = factory
        # optional batched owner resolver ``keys -> list[hostport]`` —
        # e.g. a serve-tier frontend resolving through the shared
        # device-resident ring (``serve.client.ServeClient.lookup`` /
        # an ``ShmClient`` wrapper); the scalar path stays ringpop.lookup
        self.lookup_source = lookup_source
        self._cache: dict[str, Any] = {}
        self._lock = threading.RLock()
        ringpop.register_listener(self)

    def handle_event(self, event) -> None:
        """Evict cached clients for members that became unusable
        (parity: ``router/router.go:70-84``)."""
        if isinstance(event, swim_ev.MemberlistChangesAppliedEvent):
            for change in event.changes:
                if change.status in (FAULTY, LEAVE):
                    self.remove_client(change.address)

    def _client_for(self, dest: str, me: str) -> tuple[Any, bool]:
        """Cache-or-create the client for ``dest`` — caller holds _lock."""
        client = self._cache.get(dest)
        if client is None:
            if dest == me:
                client = self.factory.get_local_client()
            else:
                client = self.factory.make_remote_client(dest)
            self._cache[dest] = client
        return client, dest == me

    def get_client(self, key: str) -> tuple[Any, bool]:
        """(client, is_local) for the owner of ``key``
        (parity: ``router/router.go:88-133`` GetClient)."""
        dest = self.ringpop.lookup(key)
        me = self.ringpop.who_am_i()
        with self._lock:
            return self._client_for(dest, me)

    def get_client_batch(self, keys: list[str]) -> list[tuple[Any, bool]]:
        """Batched GetClient: resolve every key's owner in ONE lookup —
        through the injected ``lookup_source`` when configured (the
        serve tier's shared device ring), else the host ring's
        vectorized ``lookup_batch`` — then serve clients from the same
        cache ``get_client`` uses.  The batch shape is what lets a
        frontend amortize the shared-ring round trip across its whole
        request wave instead of paying one lookup per key."""
        if not keys:
            return []
        if self.lookup_source is not None:
            dests = list(self.lookup_source(keys))
        else:
            batch = getattr(self.ringpop, "lookup_batch", None)
            if batch is not None:
                dests = batch(keys)
            else:
                dests = [self.ringpop.lookup(k) for k in keys]
        me = self.ringpop.who_am_i()
        with self._lock:
            return [self._client_for(dest, me) for dest in dests]

    def remove_client(self, hostport: str) -> None:
        with self._lock:
            self._cache.pop(hostport, None)
