"""Multi-process integration harness (counterpart of
``ringpop_tpu/harness.py``; parity: reference ``test/run-integration-tests``
— real local clusters of testpop processes driven through
convergence/failure scenarios, ``test/run-integration-tests:12,99-113``).

Spawns N ``testpop`` subprocesses on loopback ports, gives them a shared
JSON hosts file, and offers scenario primitives: wait-for-convergence (all
nodes report the same membership checksum over ``/admin/stats``), kill,
and reap checks.  Each process runs ``python -m ringpop_tpu_torch.cli.testpop``
unless ``testpop`` names another module of the same flags (one for every
process, or one a process: a cluster may mix implementations that speak
the same wire); ``extra_args`` adds flags a process (``--stats-file``, …).
Torch-free.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence, Union

from ringpop_tpu_torch.net import TCPChannel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTPOP = "ringpop_tpu_torch.cli.testpop"


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ProcessCluster:
    def __init__(
        self,
        n: int,
        suspect_period: float = 1.0,
        app: str = "testpop",
        wire: Optional[str] = None,
        testpop: Union[str, Sequence[str]] = TESTPOP,
        extra_args: Optional[Sequence[Sequence[str]]] = None,
    ):
        self.n = n
        self.app = app
        self.suspect_period = suspect_period
        self.wire = wire
        self.modules = [testpop] * n if isinstance(testpop, str) else list(testpop)
        self.extra_args = [list(a) for a in extra_args] if extra_args is not None else [[] for _ in range(n)]
        if len(self.modules) != n or len(self.extra_args) != n:
            raise ValueError(f"testpop and extra_args name one entry a process ({n})")
        self.hosts = [f"127.0.0.1:{free_port()}" for _ in range(n)]
        self.procs: dict[str, subprocess.Popen] = {}
        self._tmpdir = tempfile.mkdtemp(prefix="ringpop-itest-")
        self.hosts_file = os.path.join(self._tmpdir, "hosts.json")
        with open(self.hosts_file, "w") as f:
            json.dump(self.hosts, f)
        self._client: Optional[TCPChannel] = None

    def start(self) -> None:
        env = dict(os.environ)
        env.setdefault("PYTHONUNBUFFERED", "1")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        for hp, module, extra in zip(self.hosts, self.modules, self.extra_args):
            self.procs[hp] = subprocess.Popen(
                [
                    sys.executable,
                    "-m",
                    module,
                    "--listen",
                    hp,
                    "--hosts",
                    self.hosts_file,
                    "--app",
                    self.app,
                    "--suspect-period",
                    str(self.suspect_period),
                    "--join-timeout",
                    "1.0",
                ]
                + (["--wire", self.wire] if self.wire else [])
                + extra,
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )

    async def client(self) -> TCPChannel:
        if self._client is None:
            self._client = TCPChannel(app=self.app)
        return self._client

    async def stats(self, hostport: str, timeout: float = 2.0) -> dict:
        client = await self.client()
        return await client.call(hostport, "ringpop", "/admin/stats", {}, timeout=timeout)

    async def wait_converged(
        self, hosts: Optional[list[str]] = None, expect_members: Optional[int] = None, timeout: float = 30.0
    ) -> dict[str, dict]:
        """Poll /admin/stats until every polled node reports the same
        membership checksum (and optionally a member count)."""
        hosts = hosts or self.hosts
        deadline = time.time() + timeout
        last: dict[str, dict] = {}
        while time.time() < deadline:
            try:
                last = {hp: await self.stats(hp) for hp in hosts}
            except Exception:
                await asyncio.sleep(0.3)
                continue
            checksums = {s["membership"]["checksum"] for s in last.values()}
            counts_ok = expect_members is None or all(
                len(s["membership"]["members"]) == expect_members for s in last.values()
            )
            if len(checksums) == 1 and counts_ok:
                return last
            await asyncio.sleep(0.3)
        raise AssertionError(
            f"no convergence in {timeout}s: "
            f"{ {hp: s.get('membership', {}).get('checksum') for hp, s in last.items()} }"
        )

    async def wait_member_status(
        self, observer: str, member: str, status: str, timeout: float = 30.0
    ) -> None:
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                s = await self.stats(observer)
                for m in s["membership"]["members"]:
                    if m["address"] == member and m["status"] == status:
                        return
            except Exception:
                pass
            await asyncio.sleep(0.3)
        raise AssertionError(f"{observer} never saw {member} as {status}")

    def kill(self, hostport: str, sig=signal.SIGKILL) -> None:
        self.procs[hostport].send_signal(sig)

    async def shutdown(self) -> None:
        if self._client is not None:
            await self._client.close()
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()

    def dump_output(self) -> str:
        out = []
        for hp, p in self.procs.items():
            if p.stdout and p.poll() is not None:
                out.append(f"--- {hp} ---\n{p.stdout.read().decode(errors='replace')}")
        return "\n".join(out)
