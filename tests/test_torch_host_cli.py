"""The port's operator clients against the JAX package's.

* ``cli/admin``: a live TCP cluster of one JAX-package ``Ringpop`` and one
  of the port's; every sub-command of the port's CLI and of the JAX CLI,
  against each of the two nodes, prints the same JSON lines (the volatile
  parts of ``status`` — process usage, uptime, protocol timing — set
  aside), as ``tests/test_admin_cli.py`` drives the JAX CLI.
* ``cli/stats``: ``FileStats`` lines and ``UDPStatsd`` datagrams are byte
  for byte the JAX package's for the same calls, with the clock patched.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import socket
import time

import pytest
import torch

from ringpop_tpu.cli import admin as jadmin
from ringpop_tpu.cli import stats as jstats
from ringpop_tpu.net import TCPChannel as JChannel
from ringpop_tpu.ringpop import Ringpop as JRingpop
from ringpop_tpu_torch.cli import admin as tadmin
from ringpop_tpu_torch.cli import stats as tstats
from ringpop_tpu_torch.net import TCPChannel as TChannel
from ringpop_tpu_torch.ringpop import Ringpop as TRingpop

VOLATILE = ("process", "uptime", "protocol")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cli(module, argv) -> tuple[int, list[dict]]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.strip()]


def _steady(lines: list[dict]) -> list[dict]:
    return [{k: v for k, v in line.items() if k not in VOLATILE} for line in lines]


COMMANDS = (["health"], ["status"], ["members"], ["lookup", "some-key"], ["lookup", "another"], ["gossip", "tick"],
            ["reap"], ["heal"], ["debug", "set"], ["debug", "clear"])


def test_admin_cli_matches_the_jax_cli_on_a_mixed_cluster():
    async def main():
        jch, tch = JChannel(app="admin-test"), TChannel(app="admin-test")
        for ch in (jch, tch):
            await ch.listen()
        hosts = [jch.hostport, tch.hostport]
        rps = [JRingpop("admin-test", jch), TRingpop("admin-test", tch)]
        await asyncio.gather(*(rp.bootstrap(discover_provider=hosts) for rp in rps))
        for _ in range(100):
            if rps[0].node.memberlist.checksum() == rps[1].node.memberlist.checksum():
                break
            await asyncio.sleep(0.05)

        def drive():
            out = {}
            for cmd in COMMANDS:
                for target in hosts:
                    argv = [cmd[0], target, *cmd[1:]]
                    got = {name: _cli(mod, argv) for name, mod in (("jax", jadmin), ("port", tadmin))}
                    assert got["jax"][0] == got["port"][0] == 0, (argv, got)
                    assert _steady(got["port"][1]) == _steady(got["jax"][1]), argv
                    out[(cmd[0], *cmd[1:], target)] = got["port"][1]
            # the same answers from either node of the converged cluster
            for cmd in (["health"], ["members"], ["lookup", "some-key"], ["lookup", "another"]):
                a, b = (out[(*cmd, hp)] for hp in hosts)
                assert a == b, cmd
            status = out[("status", hosts[1])][0]
            assert status["state"] == "ready" and len(status["membership"]["members"]) == 2
            assert out[("members", hosts[1])][-1]["checksum"] == rps[1].node.memberlist.checksum()
            assert out[("lookup", "some-key", hosts[1])][0]["dest"] in hosts
            # an unreachable target: rc 1 and the same structured error
            argv = ["--timeout", "0.5", "health", "127.0.0.1:1"]
            jrc, jout = _cli(jadmin, argv)
            trc, tout = _cli(tadmin, argv)
            assert jrc == trc == 1 and tout == jout and tout[0]["ok"] is False

        await asyncio.to_thread(drive)
        for rp in rps:
            rp.destroy()
        await asyncio.gather(jch.close(), tch.close())

    asyncio.run(main())


def test_admin_cli_msgpack_wire_against_both_nodes():
    pytest.importorskip("msgpack")

    async def main():
        jch, tch = JChannel(app="admin-test", codec="msgpack"), TChannel(app="admin-test", codec="msgpack")
        for ch in (jch, tch):
            await ch.listen()
        rps = [JRingpop("admin-test", jch), TRingpop("admin-test", tch)]
        for rp, ch in zip(rps, (jch, tch)):
            await rp.bootstrap(discover_provider=[ch.hostport])

        def drive():
            for target in (jch.hostport, tch.hostport):
                argv = ["--wire", "msgpack", "health", target]
                got, want = _cli(tadmin, argv), _cli(jadmin, argv)
                assert got == want and got[0] == 0 and got[1][0]["ok"] is True

        await asyncio.to_thread(drive)
        for rp in rps:
            rp.destroy()
        await asyncio.gather(jch.close(), tch.close())

    asyncio.run(main())


# -- stats reporters ---------------------------------------------------------------

CALLS = (("incr", "ringpop.a.ping.send", 1), ("incr", "ringpop.a.ping.recv", 3), ("gauge", "ringpop.a.num-members", 5),
         ("gauge", "ringpop.a.ring.checksum", 12.25), ("timing", "ringpop.a.ping", 0.0125),
         ("timing", "ringpop.a.join", 1.5), ("incr", "x" * 60, 7))


def _feed(reporter, calls=CALLS) -> None:
    for method, key, value in calls:
        getattr(reporter, method)(key, value)


def test_file_stats_lines_are_the_jax_packages(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.123456)
    paths = {}
    for name, mod in (("jax", jstats), ("port", tstats)):
        paths[name] = tmp_path / f"{name}.txt"
        with mod.FileStats(str(paths[name])) as stats:
            _feed(stats)
        stats.incr("after-close", 1)  # dropped, never raised
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    assert paths["port"].read_text().splitlines()[0] == "1700000000.123456 count ringpop.a.ping.send 1"
    assert tstats.AggregatingStats is not None


def _udp_datagrams(mod, clock: list, **kw) -> list[bytes]:
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(2.0)
    udp = mod.UDPStatsd(f"127.0.0.1:{recv.getsockname()[1]}", **kw)
    clock[0] = 1000.0
    _feed(udp)  # the first emit flushes at once (epoch 0), the rest batch
    clock[0] = 1000.1
    _feed(udp, CALLS[:2])
    clock[0] = 1000.5  # past flush_s: this emit flushes the batch
    _feed(udp, CALLS[2:4])
    udp.flush()
    _feed(udp, CALLS[4:])
    udp.close()
    udp.incr("post-close", 1)  # dropped
    out = []
    with contextlib.suppress(socket.timeout):
        while True:
            recv.settimeout(0.3)
            out.append(recv.recv(4096))
    recv.close()
    return out


@pytest.mark.parametrize("kw", [{}, {"max_datagram": 40, "flush_s": 3600}])
def test_udp_statsd_datagrams_are_the_jax_packages(monkeypatch, kw):
    clock = [0.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    want = _udp_datagrams(jstats, clock, **kw)
    got = _udp_datagrams(tstats, clock, **kw)
    assert got == want and len(want) >= 4
    assert all(len(d) <= kw.get("max_datagram", 1432) or b"\n" not in d for d in got)
