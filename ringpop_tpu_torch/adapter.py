"""Keyed service adapter — the codegen replacement.

Parity: the reference ships a thrift-gen template (``ringpop.thrift-gen``)
that generates a per-service adapter routing each endpoint by a user-supplied
``Key(ctx, req)`` closure, handling locally when the node owns the key and
forwarding otherwise, with the forwarded-header loop guard (generated
example: ``examples/ping-thrift-gen/gen-go/ping/ringpop-ping.go:98-118``).

Python needs no codegen: :class:`ServiceAdapter` wraps any service at
runtime.  Register ``endpoint -> (key_fn, handler)`` pairs; calls landing on
a non-owner are transparently proxied to the owner, exactly once.

Counterpart of ``ringpop_tpu/adapter.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

from typing import Awaitable, Callable, Optional

from ringpop_tpu_torch.forward import Options as ForwardOptions, has_forwarded_header

KeyFn = Callable[[dict], str]
HandlerFn = Callable[[dict], Awaitable[dict]]


class EndpointConfig:
    """(parity: the generated ``<Svc>Configuration`` Key closures)"""

    def __init__(self, key_fn: KeyFn, handler: HandlerFn):
        self.key_fn = key_fn
        self.handler = handler


class ServiceAdapter:
    def __init__(
        self,
        ringpop,
        channel,
        service: str,
        endpoints: Optional[dict[str, tuple[KeyFn, HandlerFn]]] = None,
        forward_options: Optional[ForwardOptions] = None,
    ):
        self.ringpop = ringpop
        self.channel = channel
        self.service = service
        self.forward_options = forward_options
        self._endpoints: dict[str, EndpointConfig] = {}
        for ep, (key_fn, handler) in (endpoints or {}).items():
            self.register(ep, key_fn, handler)

    def register(self, endpoint: str, key_fn: KeyFn, handler: HandlerFn) -> None:
        cfg = EndpointConfig(key_fn, handler)
        self._endpoints[endpoint] = cfg

        async def wire_handler(body, headers, _cfg=cfg, _ep=endpoint):
            # loop guard: a request forwarded to us is always handled locally
            # (generated adapter behavior, ringpop-ping.go:100)
            if has_forwarded_header(headers):
                return await _cfg.handler(body)
            key = _cfg.key_fn(body)
            handled, res = await self.ringpop.handle_or_forward(
                key, body, self.service, _ep, options=self.forward_options, headers=headers
            )
            if handled:
                return await _cfg.handler(body)
            return res

        self.channel.register(self.service, endpoint, wire_handler)

    async def call(self, endpoint: str, body: dict, timeout: float = 3.0) -> dict:
        """Client-side convenience: route a request to the key's owner
        directly (local fast path, remote call otherwise)."""
        cfg = self._endpoints[endpoint]
        key = cfg.key_fn(body)
        dest = self.ringpop.lookup(key)
        if dest == self.ringpop.who_am_i():
            return await cfg.handler(body)
        return await self.channel.call(dest, self.service, endpoint, body, timeout=timeout)


def keyed(service_adapter: ServiceAdapter, endpoint: str, key: KeyFn):
    """Decorator sugar:

    >>> @keyed(adapter, "/ping", key=lambda body: body["user"])
    ... async def ping(body): return {"pong": True}
    """

    def deco(handler: HandlerFn) -> HandlerFn:
        service_adapter.register(endpoint, key, handler)
        return handler

    return deco
