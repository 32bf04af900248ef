"""testpop — standalone node binary for integration testing (counterpart of
``ringpop_tpu/cli/testpop.py``: the same flags, the same two readiness lines,
the same wire, so its processes join clusters of the JAX package's; parity:
reference ``scripts/testpop/testpop.go:38-118``).  Torch-free.

Run one framework node that listens on a TCP hostport, bootstraps from a
JSON hosts file, and gossips until killed.  Flags mirror the reference:
listen address, hosts file, stats to UDP statsd or a timestamped file, and
suspect/faulty/tombstone period overrides.

    python -m ringpop_tpu_torch.cli.testpop --listen 127.0.0.1:3000 \
        --hosts /tmp/hosts.json [--stats-file FILE | --stats-udp HOST:PORT] \
        [--suspect-period S] [--faulty-period S] [--tombstone-period S]
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys

from ringpop_tpu_torch.discovery import JSONFile
from ringpop_tpu_torch.net import TCPChannel
from ringpop_tpu_torch.options import Options
from ringpop_tpu_torch.ringpop import Ringpop
from ringpop_tpu_torch.swim.node import BootstrapOptions
from ringpop_tpu_torch.swim.state_transitions import StateTimeouts


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="testpop", description=__doc__)
    p.add_argument("--listen", required=True, help="hostport to listen on")
    p.add_argument("--hosts", required=True, help="path to JSON bootstrap hosts file")
    p.add_argument("--app", default="testpop", help="ringpop app name")
    p.add_argument("--stats-file", default=None, help="write stats to this file")
    p.add_argument("--stats-udp", default=None, help="send statsd to this hostport")
    p.add_argument("--suspect-period", type=float, default=0.0, help="seconds (0=default 5s)")
    p.add_argument("--faulty-period", type=float, default=0.0, help="seconds (0=default 24h)")
    p.add_argument("--tombstone-period", type=float, default=0.0, help="seconds (0=default 60s)")
    p.add_argument("--join-timeout", type=float, default=0.0, help="seconds per join attempt")
    p.add_argument(
        "--wire",
        choices=["json", "msgpack"],
        default=None,
        help="frame codec to SEND (receivers auto-detect; default json or "
        "$RINGPOP_TPU_WIRE)",
    )
    return p.parse_args(argv)


async def amain(args) -> int:
    stats = None
    if args.stats_file:
        from ringpop_tpu_torch.cli.stats import FileStats

        stats = FileStats(args.stats_file)
    elif args.stats_udp:
        from ringpop_tpu_torch.cli.stats import UDPStatsd

        stats = UDPStatsd(args.stats_udp)

    host, port = args.listen.rsplit(":", 1)
    channel = TCPChannel(app=args.app, codec=args.wire)
    await channel.listen(host, int(port))
    print(f"testpop listening on {channel.hostport}", flush=True)

    rp = Ringpop(
        args.app,
        channel,
        Options(
            stats_reporter=stats,
            state_timeouts=StateTimeouts(
                suspect=args.suspect_period,
                faulty=args.faulty_period,
                tombstone=args.tombstone_period,
            ),
        ),
    )
    joined = await rp.bootstrap(
        BootstrapOptions(
            discover_provider=JSONFile(args.hosts), join_timeout=args.join_timeout
        )
    )
    print(f"testpop ready; joined {len(joined)} nodes: {joined}", flush=True)

    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        rp.destroy()
        await channel.close()
        if stats is not None:
            # flush + release the reporter's file handle / UDP socket
            stats.close()
    return 0


def main(argv=None) -> int:
    return asyncio.run(amain(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
