"""SWIM admin endpoints (parity: reference ``swim/handlers.go:63-168``).

``/admin/gossip{,/start,/stop,/tick}``, ``/admin/member/{join,leave}``,
``/admin/reap``, ``/admin/healpartition/disco``, ``/admin/debugSet``/
``debugClear``.

Counterpart of ``ringpop_tpu/swim/handlers.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import logging as stdlog

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch.swim.member import FAULTY


def register_admin_handlers(node) -> None:
    svc = node.service

    async def gossip_toggle(body, headers):
        if node.gossip.stopped():
            node.gossip.start()
        else:
            node.gossip.stop()
        return {}

    async def gossip_start(body, headers):
        node.gossip.start()
        return {}

    async def gossip_stop(body, headers):
        node.gossip.stop()
        return {}

    async def tick(body, headers):
        await node.gossip.protocol_period()
        return {"checksum": node.memberlist.checksum()}

    async def member_join(body, headers):
        node.memberlist.reincarnate()
        return {"status": "rejoined"}

    async def member_leave(body, headers):
        node.memberlist.make_leave(node.address, node.memberlist.local.incarnation)
        return {"status": "ok"}

    async def reap(body, headers):
        # tombstone all faulty members cluster-wide via gossip
        for m in node.memberlist.get_members():
            if m.status == FAULTY:
                node.memberlist.make_tombstone(m.address, m.incarnation)
        return {"status": "ok"}

    async def heal_disco(body, headers):
        targets = await node.healer.heal()
        return {"targets": targets, "error": ""}

    async def debug_set(body, headers):
        logging_mod.set_levels({name: stdlog.DEBUG for name in ("gossip", "node", "membership")})
        return {}

    async def debug_clear(body, headers):
        logging_mod.set_levels({name: stdlog.ERROR for name in ("gossip", "node", "membership")})
        return {}

    node.channel.register(svc, "/admin/gossip", gossip_toggle)
    node.channel.register(svc, "/admin/gossip/start", gossip_start)
    node.channel.register(svc, "/admin/gossip/stop", gossip_stop)
    node.channel.register(svc, "/admin/tick", tick)
    node.channel.register(svc, "/admin/gossip/tick", tick)
    node.channel.register(svc, "/admin/member/join", member_join)
    node.channel.register(svc, "/admin/member/leave", member_leave)
    node.channel.register(svc, "/admin/reap", reap)
    node.channel.register(svc, "/admin/healpartition/disco", heal_disco)
    node.channel.register(svc, "/admin/debugSet", debug_set)
    node.channel.register(svc, "/admin/debugClear", debug_clear)
