"""Protocol/member stats snapshots (parity: reference ``swim/stats.go``).

Counterpart of ``ringpop_tpu/swim/stats.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

from dataclasses import dataclass

from ringpop_tpu_torch.swim.member import state_name


@dataclass
class MemberStats:
    address: str = ""
    status: str = ""
    incarnation: int = 0


def member_stats(node) -> dict:
    """(parity: ``swim/stats.go:36-60`` MemberStats)"""
    members = sorted(node.memberlist.get_members(), key=lambda m: m.address)
    return {
        "checksum": node.memberlist.checksum(),
        "members": [
            {
                "address": m.address,
                "status": state_name(m.status),
                "incarnationNumber": m.incarnation,
            }
            for m in members
        ],
    }


def protocol_stats(node) -> dict:
    """(parity: ``swim/stats.go:62-104`` ProtocolStats)"""
    timing = node.gossip.timing
    return {
        "timing": {
            "type": "histogram",
            "min": timing.min(),
            "max": timing.max(),
            "mean": timing.mean(),
            "count": timing.count,
            "p50": timing.percentile(0.50),
            "p95": timing.percentile(0.95),
            "p99": timing.percentile(0.99),
        },
        "protocolRate": node.gossip.protocol_rate(),
        "clientRate": node.client_rate.rate1(),
        "serverRate": node.server_rate.rate1(),
        "totalRate": node.total_rate.rate1(),
    }
