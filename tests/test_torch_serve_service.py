"""The port's serve-tier collector (``RingService``) against the JAX package.

Each test mirrors one of ``tests/test_serve.py``'s collector tests and runs
it through both packages on the same hashes and servers: the JAX
``RingService`` over its ``RingStore``, the port's over a CPU store.
Owners, generations, flush grouping and every non-timing telemetry field
(the totals, the ``serve`` and ``ring_update`` journal records without
their queue-wait and dispatch-time histograms, the stats counters and
gauges) must be equal.  Everything compared is an integer: the tolerance is
none.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ringpop_tpu.serve.service as jsvc
from ringpop_tpu.serve import state as jst
from ringpop_tpu.serve.client import HostBisectFrontend as JaxBisect

import ringpop_tpu_torch.serve.service as tsvc
from ringpop_tpu_torch.hashring import HashRing
from ringpop_tpu_torch.serve import state as tst
from ringpop_tpu_torch.serve.bench import ServiceThread
from ringpop_tpu_torch.serve.client import HostBisectFrontend
from ringpop_tpu_torch.serve.shm import ShmClient


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SERVERS = [f"10.7.0.{i}:3000" for i in range(24)]
TIMING = ("queue_wait_us", "dispatch_us")


def _hashes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint32)


class _Journal:
    def __init__(self):
        self.records = []

    def _write(self, obj):
        self.records.append(obj)


class _Stats:
    def __init__(self):
        self.counts = {}
        self.gauges = {}
        self.timings = []

    def incr(self, key, n=1):
        self.counts[key] = self.counts.get(key, 0) + n

    def gauge(self, key, v):
        self.gauges[key] = v

    def timing(self, key, v):
        self.timings.append((key, v))


class _Side:
    """One package's store + service + sinks, built from the same inputs."""

    def __init__(self, pkg, servers, replica_points, **svc_kw):
        self.pkg = pkg
        self.journal = _Journal()
        self.stats = _Stats()
        if pkg == "jax":
            self.store = jst.RingStore(servers, replica_points=replica_points)
            mod, self.state = jsvc, jst
        else:
            self.store = tst.RingStore(servers, replica_points=replica_points, device="cpu")
            mod, self.state = tsvc, tst
        self.mod = mod
        self.svc = mod.RingService(self.store, journal=self.journal, stats=self.stats, **svc_kw)

    def telemetry(self):
        t = self.svc.telemetry
        records = [{k: v for k, v in r.items() if k not in TIMING} for r in self.journal.records]
        return {
            "totals": (t.flushes_total, t.requests_total, t.keys_total),
            "records": records,
            "counts": self.stats.counts,
            "gauges": self.stats.gauges,
            "timing_keys": [k for k, _ in self.stats.timings],
        }


def _both(servers, replica_points, **svc_kw):
    return _Side("jax", servers, replica_points, **svc_kw), _Side("torch", servers, replica_points, **svc_kw)


def _run(side, requests):
    """Submit every ``(hashes, n)`` in one event-loop iteration; the answers
    as plain arrays and generations."""

    async def main():
        futs = [side.svc.submit(h, n=n) for h, n in requests]
        return await asyncio.gather(*futs)

    return [(np.asarray(o), int(g)) for o, g in asyncio.run(main())]


def _assert_same(jside, tside, jout, tout):
    assert len(jout) == len(tout)
    for (jo, jg), (to, tg) in zip(jout, tout):
        assert jo.dtype == to.dtype and np.array_equal(jo, to) and jg == tg
    assert jside.telemetry() == tside.telemetry()


def test_collector_coalesces_same_iteration_submits():
    j, t = _both(SERVERS, 10, flush_us=0.0, journal_every=1)
    reqs = [(_hashes(40, 1), 1), (_hashes(50, 2), 1), (_hashes(60, 3), 1)]
    jout, tout = _run(j, reqs), _run(t, reqs)
    _assert_same(j, t, jout, tout)
    oracle = HostBisectFrontend(SERVERS, 10)
    for (h, _), (owners, gen) in zip(reqs, tout):
        assert np.array_equal(owners, oracle.lookup_hashes(h)) and gen == 0
    assert t.svc.telemetry.flushes_total == 1 and t.svc.telemetry.keys_total == 150
    rec = t.journal.records[-1]
    assert rec["kind"] == "serve" and rec["requests"] == 3 and rec["keys"] == 150
    assert {"mean", "p50", "p90", "max"} <= set(rec["queue_wait_us"]) & set(rec["keys_per_flush"])


def test_collector_size_trigger_flushes_immediately():
    j, t = _both(SERVERS, 10, flush_us=10_000_000.0, max_batch=64)
    reqs = [(_hashes(80), 1)]  # over max_batch: no waiting for the timer
    t0 = time.perf_counter()
    tout = _run(t, reqs)
    assert time.perf_counter() - t0 < 5.0
    _assert_same(j, t, _run(j, reqs), tout)


def test_collector_latency_trigger_fires():
    j, t = _both(SERVERS, 10, flush_us=2000.0, max_batch=1 << 20)

    def run(side):
        async def main():
            return await asyncio.wait_for(side.svc.submit(_hashes(16)), timeout=10)

        owners, gen = asyncio.run(main())
        return [(np.asarray(owners), gen)]

    _assert_same(j, t, run(j), run(t))


def test_collector_groups_by_n():
    j, t = _both(SERVERS[:8], 10, flush_us=0.0, journal_every=1)
    h = _hashes(32, seed=7)
    reqs = [(h, 1), (h, 3), (h[:5], 3), (h[:9], 1)]
    jout, tout = _run(j, reqs), _run(t, reqs)
    _assert_same(j, t, jout, tout)
    host = HashRing(replica_points=10)
    host.add_remove_servers(SERVERS[:8], [])
    slist = host.servers()
    o3 = tout[1][0]
    for i, hh in enumerate(h.tolist()):
        want = [slist.index(s) for s in host._lookup_n_hash(hh, 3)]
        assert list(o3[i]) == want and tout[0][0][i] == want[0]
    assert t.svc.telemetry.flushes_total == 1  # one flush, two dispatches


def test_collector_rejects_bad_n():
    for side in _both(SERVERS[:4], 5):
        async def main():
            side.svc.submit(_hashes(4), n=0)

        with pytest.raises(ValueError):
            asyncio.run(main())
        with pytest.raises(ValueError):
            side.svc.submit_nowait(_hashes(4), 0, lambda rows, gen: None)


def test_dispatch_direct_matches_collector_and_telemeters():
    j, t = _both(SERVERS, 10, journal_every=1)
    h = _hashes(8, seed=9)
    got = {"jax": [], "torch": []}
    for side in (j, t):
        for n in (1, 2):
            side.svc.dispatch_direct(h, n, lambda rows, gen, k=side.pkg: got[k].append((np.asarray(rows), gen)))
    _assert_same(j, t, got["jax"], got["torch"])
    oracle = HostBisectFrontend(SERVERS, 10).lookup_hashes(h)
    (rows1, gen), (rows2, _) = got["torch"]
    assert np.array_equal(rows1, oracle) and gen == 0 and rows2.shape == (8, 2)
    # n > 1 answers from the host mirror equal the fused device dispatch
    ring, _g, ns = t.store.snapshot()
    fused = tst.serve_lookup_n_fused(ring, ns, torch.from_numpy(h.astype(np.int64)), 2).numpy()
    assert np.array_equal(rows2, fused[:-1].reshape(8, 2))


def test_ring_update_journal_and_stats():
    j, t = _both(SERVERS[:4], 10)
    for side in (j, t):
        side.store.update(add=["w:1"])
        side.store.update(remove=[SERVERS[0]])
    _assert_same(j, t, [], [])
    rec = t.journal.records[-2]
    assert rec["kind"] == "ring_update" and rec["gen"] == 1
    assert rec["n_servers"] == 5 and not rec["reallocated"]
    assert t.stats.gauges["ringpop.serve.ring.servers"] == 4
    assert t.stats.counts["ringpop.serve.ring.changed"] == 2


def test_a_flush_around_one_concurrent_commit():
    """A commit lands while requests are pending: the flush answers from
    the newest generation, and a snapshot taken before the commit still
    answers at ITS generation (ping-pong: commit N overwrites N-2)."""
    j, t = _both(SERVERS, 10, flush_us=0.0, journal_every=1)
    h = _hashes(128, seed=21)

    def run(side):
        old_ring, old_gen, _ = side.store.snapshot()
        old_servers = side.store.servers_at(old_gen)

        async def main():
            fut = side.svc.submit(h)
            side.store.update(add=["race:1"])  # before the flush runs
            return await fut

        owners, gen = asyncio.run(main())
        keys = jnp.asarray(h) if side.pkg == "jax" else torch.from_numpy(h.astype(np.int64))
        old_owners, old_g = side.state.serve_lookup(old_ring, keys)
        assert int(np.asarray(old_g)[0]) == old_gen == 0
        assert np.array_equal(np.asarray(old_owners), HostBisectFrontend(old_servers, 10).lookup_hashes(h))
        return [(np.asarray(owners), gen), (np.asarray(old_owners), int(np.asarray(old_g)[0]))]

    jout, tout = run(j), run(t)
    _assert_same(j, t, jout, tout)
    assert tout[0][1] == 1
    assert np.array_equal(tout[0][0], HostBisectFrontend(t.store.servers_at(1), 10).lookup_hashes(h))


def test_flush_retries_on_a_stale_ring(monkeypatch):
    """The first dispatch attempt meets a ring recommitted under it (the
    JAX package's deleted donated buffer, the port's ``StaleRingError``):
    the flush refetches the newest snapshot and answers from it — one
    retry, one flush, nothing strands."""
    j, t = _both(SERVERS, 10, flush_us=0.0, journal_every=1)
    stale = {"jax": RuntimeError("Array has been deleted with shape=uint32[6400]"),
             "torch": tst.StaleRingError("this ring view is stale")}
    h = _hashes(32, seed=23)
    outs, calls = {}, {}
    for side in (j, t):
        real = side.mod.serve_lookup_fused
        calls[side.pkg] = 0

        def flaky(ring, hashes, real=real, pkg=side.pkg):
            calls[pkg] += 1
            if calls[pkg] == 1:
                raise stale[pkg]
            return real(ring, hashes)

        monkeypatch.setattr(side.mod, "serve_lookup_fused", flaky)
        outs[side.pkg] = _run(side, [(h, 1)])
    assert calls == {"jax": 2, "torch": 2}
    _assert_same(j, t, outs["jax"], outs["torch"])
    assert np.array_equal(outs["torch"][0][0], HostBisectFrontend(SERVERS, 10).lookup_hashes(h))


def test_only_a_stale_ring_is_retried(monkeypatch):
    """Any other ``RuntimeError`` from the dispatch, the JAX package's own
    retry message included, fails the request at once."""
    t = _Side("torch", SERVERS, 10, flush_us=0.0)
    calls = []

    def broken(ring, hashes):
        calls.append(1)
        raise RuntimeError("Array has been deleted with shape=uint32[6400]")

    monkeypatch.setattr(tsvc, "serve_lookup_fused", broken)
    with pytest.raises(RuntimeError, match="deleted"):
        _run(t, [(_hashes(8), 1)])
    assert len(calls) == 1


def test_flush_failure_fails_futures_not_hangs(monkeypatch):
    """A non-retryable dispatch error surfaces on the future (and as
    ``(None, -1)`` on a callback sink), never strands it pending."""
    for side in _both(SERVERS, 10, flush_us=0.0):
        def broken(ring, hashes):
            raise ValueError("boom")

        monkeypatch.setattr(side.mod, "serve_lookup_fused", broken)

        async def main():
            got = []
            side.svc.submit_nowait(_hashes(8, 1), 1, lambda rows, gen: got.append((rows, gen)))
            with pytest.raises(ValueError):
                await asyncio.wait_for(side.svc.submit(_hashes(8)), timeout=10)
            return got

        assert asyncio.run(main()) == [(None, -1)]
        assert side.svc.telemetry.flushes_total == 1


def test_shm_slot_not_poisoned_by_dispatch_error(monkeypatch):
    """A dispatch exception answers STATUS_ERR (the client raises) and
    frees the slot: the NEXT request on the same slot succeeds."""
    store = tst.RingStore(SERVERS, replica_points=10, device="cpu")
    th = ServiceThread(store, flush_us=0.0, shm_slots=2, shm_key_cap=4096, shm_max_n=4)
    real = tsvc.serve_lookup_fused
    fail_once = {"armed": True}

    def flaky(ring, hashes):
        if fail_once["armed"]:
            fail_once["armed"] = False
            raise ValueError("injected dispatch failure")
        return real(ring, hashes)

    monkeypatch.setattr(tsvc, "serve_lookup_fused", flaky)
    th.start()
    out = {}
    big = _hashes(600, seed=27)  # > 64 keys: rides the collector, meets flaky

    def client_run():
        name, sock, slots, cap, max_n = th.shm_address()
        cl = ShmClient(name, sock, 0, slots=slots, key_cap=cap, max_n=max_n)
        try:
            cl.lookup_hashes(big)
            out["first"] = "ok"
        except RuntimeError:
            out["first"] = "error"
        out["second"] = cl.lookup_hashes(big)
        cl.close()

    try:
        c = threading.Thread(target=client_run)
        c.start()
        c.join(timeout=60)
        assert not c.is_alive()
    finally:
        th.stop()
    assert out["first"] == "error"
    owners, gen = out["second"]
    assert gen == 0 and np.array_equal(owners, JaxBisect(SERVERS, 10).lookup_hashes(big))


def test_service_chains_existing_on_update_hook():
    """RingService does not replace a caller-installed
    ``RingStore(on_update=...)`` hook: both fire per generation."""
    got = {}
    for pkg, mod, store_cls, kw in (("jax", jsvc, jst.RingStore, {}),
                                    ("torch", tsvc, tst.RingStore, {"device": "cpu"})):
        seen = []
        store = store_cls(SERVERS[:4], replica_points=5, on_update=seen.append, **kw)
        journal = _Journal()
        mod.RingService(store, journal=journal)
        store.update(add=["hooked:1"])
        assert len(seen) == 1 and seen[0]["gen"] == 1
        assert journal.records == seen
        got[pkg] = seen
    assert got["jax"] == got["torch"]
