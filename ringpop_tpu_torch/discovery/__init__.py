"""Bootstrap host discovery (parity: reference ``discovery/types.go``).

``DiscoverProvider`` abstracts where the bootstrap host list comes from; the
two reference implementations — static list and JSON file — are provided
(``discovery/statichosts/lib.go``, ``discovery/jsonfile/lib.go``).

Counterpart of ``ringpop_tpu/discovery/__init__.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import json
from typing import Callable, Protocol, Sequence


class DiscoverProvider(Protocol):
    def hosts(self) -> list[str]: ...


class StaticHosts:
    """Fixed host list (parity: ``discovery/statichosts/lib.go``)."""

    def __init__(self, *hosts: str):
        if len(hosts) == 1 and isinstance(hosts[0], (list, tuple)):
            hosts = tuple(hosts[0])
        self._hosts = list(hosts)

    def hosts(self) -> list[str]:
        return list(self._hosts)


class JSONFile:
    """Hosts from a JSON array file, re-read on every call
    (parity: ``discovery/jsonfile/lib.go``)."""

    def __init__(self, path: str):
        self.path = path

    def hosts(self) -> list[str]:
        with open(self.path) as f:
            hosts = json.load(f)
        if not isinstance(hosts, list) or not all(isinstance(h, str) for h in hosts):
            raise ValueError(f"{self.path}: expected a JSON array of hostport strings")
        return hosts


class CallableProvider:
    """Adapter for a plain function returning hosts."""

    def __init__(self, fn: Callable[[], Sequence[str]]):
        self._fn = fn

    def hosts(self) -> list[str]:
        return list(self._fn())


def as_provider(source) -> DiscoverProvider:
    """Coerce a provider, list of hosts, path-like, or callable into a
    DiscoverProvider."""
    if hasattr(source, "hosts"):
        return source
    if callable(source):
        return CallableProvider(source)
    if isinstance(source, str):
        return JSONFile(source)
    if isinstance(source, (list, tuple)):
        return StaticHosts(*source)
    raise TypeError(f"cannot make a DiscoverProvider from {type(source)!r}")
