"""The port's process entry points over real OS processes on loopback:
``ringpop_tpu_torch.harness.ProcessCluster`` of ``python -m
ringpop_tpu_torch.cli.testpop`` processes, driven through the scenarios of
``tests/test_integration_processes.py`` (clusters of 2 and 3, a killed
process detected faulty, 5 with a reap, a leave and a rejoin over the
wire, the msgpack codec; the 10-process run is ``slow``, as there), and a
mixed cluster of the JAX package's and the port's testpop processes that
converges to one membership checksum: the two speak the same wire.  The
processes import no torch (``tests/test_torch_slice.py`` checks the
modules).
"""

import signal

import pytest
import torch

from ringpop_tpu_torch.harness import ProcessCluster

from swim_utils import run

JAX_TESTPOP = "ringpop_tpu.cli.testpop"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _all_alive(stats: dict) -> bool:
    return all(m["status"] == "alive" for s in stats.values() for m in s["membership"]["members"])


@pytest.mark.parametrize("n", [2, 3])
def test_process_cluster_converges(n):
    async def main():
        cluster = ProcessCluster(n)
        cluster.start()
        try:
            stats = await cluster.wait_converged(expect_members=n, timeout=45)
            assert _all_alive(stats) and {s["state"] for s in stats.values()} == {"ready"}
        finally:
            await cluster.shutdown()

    run(main())


@pytest.mark.slow
def test_ten_process_cluster_converges():
    """The reference's largest integration size (test/run-integration-tests:12)."""

    async def main():
        cluster = ProcessCluster(10)
        cluster.start()
        try:
            stats = await cluster.wait_converged(expect_members=10, timeout=90)
            assert len(stats) == 10
        finally:
            await cluster.shutdown()

    run(main())


def test_killed_process_is_detected_faulty():
    async def main():
        cluster = ProcessCluster(3, suspect_period=1.0)
        cluster.start()
        try:
            await cluster.wait_converged(expect_members=3, timeout=45)
            victim, survivors = cluster.hosts[2], cluster.hosts[:2]
            cluster.kill(victim, signal.SIGKILL)
            for obs in survivors:
                await cluster.wait_member_status(obs, victim, "faulty", timeout=45)
        finally:
            await cluster.shutdown()

    run(main())


def test_five_process_cluster_and_reap(tmp_path):
    """Five processes, one writing its stats to a file; one killed, seen
    faulty, reaped over the admin endpoint, and the survivors re-converge.
    The stats file holds the gossip counters in ``FileStats``' line form."""
    stats_file = tmp_path / "stats.txt"

    async def main():
        cluster = ProcessCluster(5, suspect_period=1.0,
                                 extra_args=[["--stats-file", str(stats_file)]] + [[]] * 4)
        cluster.start()
        try:
            await cluster.wait_converged(expect_members=5, timeout=60)
            victim, survivors = cluster.hosts[4], cluster.hosts[:4]
            cluster.kill(victim, signal.SIGKILL)
            await cluster.wait_member_status(survivors[0], victim, "faulty", timeout=45)
            client = await cluster.client()
            await client.call(survivors[0], "ringpop", "/admin/reap", {}, timeout=2.0)
            await cluster.wait_converged(hosts=survivors, timeout=45)
        finally:
            await cluster.shutdown()

    run(main())
    lines = stats_file.read_text().splitlines()
    kinds = {line.split(" ")[1] for line in lines}
    keys = {line.split(" ")[2] for line in lines}
    assert kinds <= {"count", "gauge", "timing"} and "count" in kinds
    assert any(".ping.send" in k for k in keys) and any(".ping.recv" in k for k in keys)
    assert all(len(line.split(" ")) == 4 and float(line.split(" ")[0]) > 0 for line in lines)


def test_graceful_leave_and_rejoin_over_the_wire():
    async def main():
        cluster = ProcessCluster(3, suspect_period=1.0)
        cluster.start()
        try:
            await cluster.wait_converged(expect_members=3, timeout=45)
            leaver, observer = cluster.hosts[2], cluster.hosts[0]
            client = await cluster.client()
            await client.call(leaver, "ringpop", "/admin/member/leave", {}, timeout=2.0)
            await cluster.wait_member_status(observer, leaver, "leave", timeout=45)
            await client.call(leaver, "ringpop", "/admin/member/join", {}, timeout=2.0)
            await cluster.wait_member_status(observer, leaver, "alive", timeout=45)
            await cluster.wait_converged(timeout=45)
        finally:
            await cluster.shutdown()

    run(main())


def test_msgpack_wire_process_cluster():
    pytest.importorskip("msgpack")

    async def main():
        cluster = ProcessCluster(3, wire="msgpack")
        cluster.start()
        try:
            stats = await cluster.wait_converged(expect_members=3, timeout=45)
            assert _all_alive(stats)
        finally:
            await cluster.shutdown()

    run(main())


def test_mixed_cluster_of_both_packages_converges_to_one_checksum():
    """Two JAX-package testpop processes and two of the port's bootstrap from
    one hosts file, converge to one membership checksum and one ring
    checksum, and see a killed port process faulty from both sides."""

    async def main():
        modules = [JAX_TESTPOP, "ringpop_tpu_torch.cli.testpop"] * 2
        cluster = ProcessCluster(4, suspect_period=1.0, testpop=modules)
        cluster.start()
        try:
            stats = await cluster.wait_converged(expect_members=4, timeout=60)
            assert _all_alive(stats)
            assert len({s["ring"]["checksum"] for s in stats.values()}) == 1
            for hp, p in cluster.procs.items():
                assert p.poll() is None, cluster.dump_output()
            victim = cluster.hosts[3]
            cluster.kill(victim, signal.SIGKILL)
            for obs in cluster.hosts[:2]:  # a JAX process, then a port process
                await cluster.wait_member_status(obs, victim, "faulty", timeout=45)
            await cluster.wait_converged(hosts=cluster.hosts[:3], timeout=45)
        finally:
            await cluster.shutdown()

    run(main())


def test_processes_print_the_readiness_lines():
    """Each port process prints testpop's two readiness lines, as the JAX
    package's does."""

    async def main():
        cluster = ProcessCluster(2)
        cluster.start()
        try:
            await cluster.wait_converged(expect_members=2, timeout=45)
        finally:
            await cluster.shutdown()
        return cluster

    cluster = run(main())
    for hp, p in cluster.procs.items():
        out = p.stdout.read().decode().splitlines()
        assert out[0] == f"testpop listening on {hp}"
        assert out[1].startswith("testpop ready; joined 1 nodes: ")
