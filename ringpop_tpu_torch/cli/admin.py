"""ringpop-admin — operate a live node over its admin endpoints (counterpart
of ``ringpop_tpu/cli/admin.py``: the same sub-commands and JSON lines, over
the port's torch-free ``net.TCPChannel``).

The reference ecosystem drives nodes through the same wire surface
(`swim/handlers.go:63-82` admin endpoint table, facade `handlers.go:33-43`);
this CLI is the operator client for it.  Every command is one RPC to one
node; cluster-wide views come from asking any member (membership is
gossip-replicated).

Usage::

    python -m ringpop_tpu_torch.cli.admin status   HOST:PORT
    python -m ringpop_tpu_torch.cli.admin members  HOST:PORT
    python -m ringpop_tpu_torch.cli.admin lookup   HOST:PORT KEY
    python -m ringpop_tpu_torch.cli.admin health   HOST:PORT
    python -m ringpop_tpu_torch.cli.admin gossip   HOST:PORT {start|stop|tick}
    python -m ringpop_tpu_torch.cli.admin member   HOST:PORT {join|leave}
    python -m ringpop_tpu_torch.cli.admin reap     HOST:PORT
    python -m ringpop_tpu_torch.cli.admin heal     HOST:PORT
    python -m ringpop_tpu_torch.cli.admin debug    HOST:PORT {set|clear}

Output is JSON (one object per line) so it pipes into jq; ``--wire
msgpack`` talks the binary codec to msgpack-pinned clusters (auto-detected
by receivers either way).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


async def _call(target: str, endpoint: str, body: dict, wire: str | None, timeout: float):
    from ringpop_tpu_torch.net import TCPChannel

    ch = TCPChannel(app="ringpop-admin", codec=wire)
    try:
        return await ch.call(target, "ringpop", endpoint, body, timeout=timeout)
    finally:
        await ch.close()


def _emit(obj) -> None:
    print(json.dumps(obj, indent=None, sort_keys=True))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ringpop-admin", description=__doc__)
    p.add_argument("--wire", choices=["json", "msgpack"], default=None)
    p.add_argument("--timeout", type=float, default=5.0)
    sub = p.add_subparsers(dest="cmd", required=True)

    for name in ("status", "members", "health", "reap", "heal"):
        sp = sub.add_parser(name)
        sp.add_argument("target", help="HOST:PORT of any cluster member")

    sp = sub.add_parser("lookup")
    sp.add_argument("target")
    sp.add_argument("key")

    sp = sub.add_parser("gossip")
    sp.add_argument("target")
    sp.add_argument("action", choices=["start", "stop", "tick"])

    sp = sub.add_parser("member")
    sp.add_argument("target")
    sp.add_argument("action", choices=["join", "leave"])

    sp = sub.add_parser("debug")
    sp.add_argument("target")
    sp.add_argument("action", choices=["set", "clear"])

    args = p.parse_args(argv)

    endpoint, body = {
        "status": ("/admin/stats", {}),
        "members": ("/admin/stats", {}),
        "health": ("/health", {}),
        "lookup": ("/admin/lookup", {"key": getattr(args, "key", "")}),
        "reap": ("/admin/reap", {}),
        "heal": ("/admin/healpartition/disco", {}),
        "gossip": (f"/admin/gossip/{getattr(args, 'action', '')}", {}),
        "member": (f"/admin/member/{getattr(args, 'action', '')}", {}),
        "debug": (
            "/admin/debugSet" if getattr(args, "action", "") == "set" else "/admin/debugClear",
            {},
        ),
    }[args.cmd]
    if args.cmd == "gossip" and args.action == "tick":
        endpoint = "/admin/tick"

    try:
        res = asyncio.run(_call(args.target, endpoint, body, args.wire, args.timeout))
    except Exception as e:
        _emit({"ok": False, "target": args.target, "error": f"{type(e).__name__}: {e}"})
        return 1

    if args.cmd == "members":
        # distill the stats payload into one row per member
        for m in (res.get("membership") or {}).get("members", []):
            _emit(m)
        _emit(
            {
                "checksum": (res.get("membership") or {}).get("checksum"),
                "ring_checksum": (res.get("ring") or {}).get("checksum"),
                "state": res.get("state"),
            }
        )
    else:
        _emit(res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
