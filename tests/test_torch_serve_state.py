"""The PyTorch port's HashRing and serve-ring state against the JAX package.

A seeded add/remove sequence drives both packages' ``HashRing`` and
``RingStore``: token arrays, checksums, commit records (generation, count,
capacity reallocation), host mirrors and the fused serve lookups must be
equal.  A JAX ``DeviceRing`` carried across with ``device_ring_from_numpy``
answers identically, and a snapshot survives one commit.  A commit racing
a lookup, forced at each seam and run from threads, never tears its
answer: the lookup answers one whole generation or raises
``StaleRingError``.  Everything compared is an integer: the tolerance is
none.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ringpop_tpu.hashring import HashRing as JaxHashRing
from ringpop_tpu.ops.ring_ops import host_lookup_n as jax_host_lookup_n
from ringpop_tpu.serve import state as jst

from ringpop_tpu_torch.events import RingChangedEvent
from ringpop_tpu_torch.hashring import HashRing
from ringpop_tpu_torch.ops.ring_ops import host_lookup_n
from ringpop_tpu_torch.serve import state as tst


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _servers(prefix, n):
    return [f"10.{prefix}.{i // 200}.{i % 200}:3000" for i in range(n)]


def _churn_plan(seed, n_steps=8):
    """Seeded membership changes: (add, remove) batches over a pool,
    including a server added and removed in one batch and re-adds."""
    rng = np.random.default_rng(seed)
    pool = _servers(7, 40)
    live = set(pool[:10])
    plan = [(sorted(live), [])]
    for step in range(n_steps):
        out = sorted(rng.choice(sorted(live), size=int(rng.integers(1, 4)), replace=False))
        cand = sorted(set(pool) - live)
        add = sorted(rng.choice(cand, size=int(rng.integers(1, 6)), replace=False))
        if step == 3:
            add.append(pool[-1])
            out.append(pool[-1])  # flapping: added then removed in one batch
        plan.append((add, out))
        live = (live | set(add)) - set(out)
    return plan


def _hashes(n, seed):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([h, np.array([0, 1, 2**31, 2**32 - 1], np.uint32)])


def _t(h):
    return torch.from_numpy(h.astype(np.int64))


@pytest.mark.parametrize("seed", [1, 2])
def test_hashring_matches_jax(seed):
    ring, jring = HashRing(replica_points=12), JaxHashRing(replica_points=12)
    events, jevents = [], []

    class _Rec:
        def __init__(self, sink):
            self.sink = sink

        def handle_event(self, e):
            self.sink.append((type(e).__name__, dict(vars(e))))

    ring.register_listener(_Rec(events))
    jring.register_listener(_Rec(jevents))
    for add, remove in _churn_plan(seed):
        assert ring.add_remove_servers(add, remove) == jring.add_remove_servers(add, remove)
        t, o, s = ring.token_arrays()
        jt, jo, js = jring.token_arrays()
        assert np.array_equal(t, jt) and np.array_equal(o, jo) and s == js
        assert ring.checksum() == jring.checksum()
        keys = [f"user:{i}" for i in range(40)]
        assert ring.lookup_batch(keys) == jring.lookup_batch(keys)
        assert ring.lookup_n_batch(keys, 3) == jring.lookup_n_batch(keys, 3)
        assert [ring.lookup_n(k, 2) for k in keys[:8]] == [jring.lookup_n(k, 2) for k in keys[:8]]
        # the incremental arrays equal the from-scratch rebuild oracle
        twin = HashRing(replica_points=12)
        twin._server_tokens = dict(ring._server_tokens)
        twin._rebuild()
        assert np.array_equal(twin._tokens, t) and np.array_equal(twin._owners, o)
    assert events == jevents


def test_ring_store_matches_jax():
    plan = _churn_plan(3)
    records, jrecords = [], []
    store = tst.RingStore(plan[0][0], replica_points=8, capacity=96,
                          on_update=records.append, device="cpu")
    jstore = jst.RingStore(plan[0][0], replica_points=8, capacity=96, on_update=jrecords.append)
    keys = _hashes(300, seed=5)
    for add, remove in [([], [])] + plan[1:]:
        if add or remove:
            assert store.update(add, remove) == jstore.update(add, remove)
        ring, gen, ns = store.snapshot()
        jring, jgen, jns = jstore.snapshot()
        assert (gen, ns, store.capacity) == (jgen, jns, jstore.capacity)
        ht, ho, hg, hns = store.snapshot_host()
        jht, jho, jhg, jhns = jstore.snapshot_host()
        assert np.array_equal(ht, jht) and np.array_equal(ho, jho) and (hg, hns) == (jhg, jhns)
        assert store.servers_at(gen) == jstore.servers_at(jgen)
        for leaf, jleaf in zip(ring, jring):
            assert np.array_equal(leaf.numpy(), np.asarray(jleaf).astype(leaf.numpy().dtype))
        fused = tst.serve_lookup_fused(ring, _t(keys))
        assert fused.dtype == torch.int32 and int(fused[-1]) == gen
        assert np.array_equal(fused.numpy(), np.asarray(jst.serve_lookup_fused(jring, jnp.asarray(keys))))
        for n in (1, 3, ns + 2):
            got = tst.serve_lookup_n_fused(ring, ns, _t(keys), n)
            want = jst.serve_lookup_n_fused(jring, jns, jnp.asarray(keys), n)
            assert np.array_equal(got.numpy(), np.asarray(want)), (gen, n)
            assert np.array_equal(got[:-1].reshape(-1, n).numpy(), host_lookup_n(ht, ho, keys, n, ns))
    assert records == jrecords
    assert any(r["reallocated"] for r in records)  # the plan outgrows capacity 96
    assert store.drain([plan[-1][0][0]]) == jstore.drain([plan[-1][0][0]])
    assert store.rescore_placement() is None and jstore.rescore_placement() is None


def test_device_ring_from_numpy_answers_like_jax():
    servers = _servers(3, 20)
    jstore = jst.RingStore(servers, replica_points=16)
    jstore.update(remove=servers[:2])
    jring, jgen, jns = jstore.snapshot()
    ring = tst.device_ring_from_numpy(*(np.asarray(leaf) for leaf in jring), device="cpu")
    assert ring.tokens.dtype == torch.int64 and ring.gen.dtype == torch.int64
    assert int(ring.count[0]) == jstore.host_tokens.shape[0] and int(ring.gen[0]) == jgen
    keys = _hashes(500, seed=6)
    owners, gen = tst.serve_lookup(ring, _t(keys))
    jowners, jg = jst.serve_lookup(jring, jnp.asarray(keys))
    assert np.array_equal(owners.numpy(), np.asarray(jowners)) and int(gen[0]) == int(jg[0])
    n_owners, _ = tst.serve_lookup_n(ring, jns, _t(keys), 3)
    assert np.array_equal(n_owners.numpy(), jax_host_lookup_n(jstore.host_tokens, jstore.host_owners, keys, 3, jns))
    for n in (2, 4):
        assert np.array_equal(
            tst.serve_lookup_n_fused(ring, jns, _t(keys), n).numpy(),
            np.asarray(jst.serve_lookup_n_fused(jring, jns, jnp.asarray(keys), n)),
        )


def test_snapshot_survives_one_commit():
    """Ping-pong: a snapshot taken before a commit still answers, at ITS
    generation, after that commit; commit N overwrites generation N-2's
    tensors in place, so two commits later the old snapshot's tensors hold
    the new generation (and a lookup through it is refused: see
    ``test_snapshot_two_commits_old_is_refused``)."""
    servers = _servers(4, 12)
    store = tst.RingStore(servers, replica_points=10, device="cpu")
    probe = _t(_hashes(128, seed=21))
    ring0, gen0, _ = store.snapshot()
    want0 = tst.serve_lookup_fused(ring0, probe).clone()
    store.update(add=["race:1"])
    assert torch.equal(tst.serve_lookup_fused(ring0, probe), want0)
    assert int(tst.serve_lookup(ring0, probe)[1][0]) == gen0
    ring1, gen1, _ = store.snapshot()
    store.update(add=["race:2"])  # overwrites ring0's tensors (gen 0 -> gen 2)
    ring2, gen2, _ = store.snapshot()
    assert ring2.tokens.data_ptr() == ring0.tokens.data_ptr()
    assert int(ring0.gen[0]) == gen2 == 2
    ht, ho, _, _ = store.snapshot_host()
    idx = np.searchsorted(ht, probe.numpy().astype(np.uint32))
    idx[idx == ht.shape[0]] = 0
    assert np.array_equal(tst.serve_lookup_fused(ring2, probe)[:-1].numpy(), ho[idx])
    assert int(tst.serve_lookup_fused(ring1, probe)[-1]) == gen1  # one commit old: intact


@pytest.mark.parametrize("read", [
    lambda ring, ns, keys: tst.serve_lookup(ring, keys),
    lambda ring, ns, keys: tst.serve_lookup_fused(ring, keys),
    lambda ring, ns, keys: tst.serve_lookup_n(ring, ns, keys, 3),
    lambda ring, ns, keys: tst.serve_lookup_n_fused(ring, ns, keys, 3),
], ids=["serve_lookup", "serve_lookup_fused", "serve_lookup_n", "serve_lookup_n_fused"])
def test_snapshot_two_commits_old_is_refused(read):
    """A snapshot held across two commits would read the newer ring, sized
    by its stale ``n_servers``; every lookup through it raises the named
    ``StaleRingError`` instead (the JAX version raises "deleted buffer"),
    while the snapshot one commit old and the current one still answer, and
    a fresh snapshot after the error reads the current generation."""
    servers = _servers(4, 12)
    store = tst.RingStore(servers, replica_points=10, device="cpu")
    probe = _t(_hashes(64, seed=22))
    ring0, _, ns0 = store.snapshot()
    store.update(add=["race:1"])
    read(ring0, ns0, probe)  # one commit old: still valid
    ring1, gen1, ns1 = store.snapshot()
    store.update(remove=servers[:3])
    with pytest.raises(tst.StaleRingError, match="stale"):
        read(ring0, ns0, probe)
    assert issubclass(tst.StaleRingError, RuntimeError)
    read(ring1, ns1, probe)
    ring2, gen2, ns2 = store.snapshot()
    assert gen2 == gen1 + 1 == 2 and ns2 == ns1 - 3
    fused = tst.serve_lookup_fused(ring2, probe)
    assert int(fused[-1]) == gen2
    ht, ho, _, _ = store.snapshot_host()
    idx = np.searchsorted(ht, probe.numpy().astype(np.uint32))
    idx[idx == ht.shape[0]] = 0
    assert np.array_equal(fused[:-1].numpy(), ho[idx])


def test_listen_to_commits_each_ring_change():
    ring = HashRing(replica_points=6)
    store = tst.RingStore(replica_points=6, device="cpu")
    store.listen_to(ring)
    ring.add_remove_servers(_servers(5, 4), [])
    ring.remove_server(_servers(5, 4)[0])
    ring.emitter.emit(RingChangedEvent())  # an empty change commits nothing
    assert store.gen == 2 and store.ring.servers() == ring.servers()


def test_placement_options():
    # DGRO placement is ported: the store places as the JAX one does (its
    # records and lookups are held to the JAX store in test_torch_placement.py)
    kw = dict(placement="dgro", placement_kw={"candidates": 2, "probes": 256})
    store = tst.RingStore(_servers(6, 2), device="cpu", **kw)
    jstore = jst.RingStore(_servers(6, 2), **kw)
    assert np.array_equal(store.host_tokens, jstore.host_tokens)
    assert store.placement_report == jstore.placement_report
    with pytest.raises(ValueError):
        tst.RingStore(_servers(6, 2), placement="nope", device="cpu")


READS = {
    "serve_lookup": lambda ring, ns, keys: tst.serve_lookup(ring, keys)[0].numpy().reshape(-1),
    "serve_lookup_fused": lambda ring, ns, keys: tst.serve_lookup_fused(ring, keys)[:-1].numpy(),
    "serve_lookup_n": lambda ring, ns, keys: tst.serve_lookup_n(ring, ns, keys, 3)[0].numpy().reshape(-1),
    "serve_lookup_n_fused": lambda ring, ns, keys: tst.serve_lookup_n_fused(ring, ns, keys, 3)[:-1].numpy(),
}


def _generation_answer(store, read, keys):
    """What ``read`` answers from the store's committed generation, by the
    host oracles (searchsorted for one owner, ``host_lookup_n`` for three)."""
    ht, ho, _, ns = store.snapshot_host()
    h = keys.numpy().astype(np.uint32)
    if read.endswith("_n") or read.endswith("_n_fused"):
        return host_lookup_n(ht, ho, h, 3, ns).reshape(-1)
    idx = np.searchsorted(ht, h)
    idx[idx == ht.shape[0]] = 0
    return ho[idx]


def _torn_read_setup():
    """A store at generation 1 with a reader holding generation 0's view:
    the next commit (generation 2) overwrites that view's buffers in place.
    Generation 2 swaps most of the servers, so an answer that mixes the two
    generations' tokens and owners matches neither."""
    servers = _servers(8, 16)
    store = tst.RingStore(servers, replica_points=10, device="cpu")
    keys = _t(_hashes(512, seed=31))
    ring0, _, ns0 = store.snapshot()
    store.update(add=["race:1"])
    return store, ring0, ns0, keys, (_servers(9, 12), servers[:13])


@pytest.mark.parametrize("read", sorted(READS))
@pytest.mark.parametrize("where", ["lookup_inside_a_commit", "commit_inside_a_lookup"])
def test_a_commit_racing_a_lookup_never_tears_its_answer(read, where, monkeypatch):
    """A commit from another thread writes a generation in place, tensor by
    tensor, into the buffers a reader's view still points at.  Forced here
    at each seam: the lookup runs between the commit's token and owner
    copies (``lookup_inside_a_commit``), or the whole commit lands between
    the lookup's searchsorted and its owner gather
    (``commit_inside_a_lookup``).  The lookup must answer one whole
    generation or raise ``StaleRingError`` — never new tokens with old
    owners."""
    store, ring0, ns0, keys, churn = _torn_read_setup()
    answers = {0: READS[read](ring0, ns0, keys)}  # one commit old: still valid
    got = {}

    def lookup():
        try:
            got["answer"] = READS[read](ring0, ns0, keys)
        except tst.StaleRingError:
            got["answer"] = "stale"

    armed = [True]
    if where == "lookup_inside_a_commit":
        real_copy = torch.Tensor.copy_

        def copy_(self, src, *args, **kwargs):
            out = real_copy(self, src, *args, **kwargs)
            if armed[0] and self.data_ptr() == ring0.tokens.data_ptr():
                armed[0] = False
                lookup()
            return out

        monkeypatch.setattr(torch.Tensor, "copy_", copy_)
        store.update(*churn)
    else:
        real_searchsorted = torch.searchsorted

        def searchsorted(*args, **kwargs):
            out = real_searchsorted(*args, **kwargs)
            if armed[0]:
                armed[0] = False
                store.update(*churn)
            return out

        monkeypatch.setattr(torch, "searchsorted", searchsorted)
        lookup()
    monkeypatch.undo()
    assert not armed[0] and store.gen == 2
    answers[2] = _generation_answer(store, read, keys)
    assert not np.array_equal(answers[0], answers[2])
    answer = got["answer"]
    assert isinstance(answer, str) or any(np.array_equal(answer, a) for a in answers.values()), (
        "the lookup answered a mix of two generations")
    # a fresh snapshot reads generation 2 whole
    ring2, gen2, ns2 = store.snapshot()
    assert gen2 == 2 and np.array_equal(READS[read](ring2, ns2, keys), answers[2])


def test_lookups_under_concurrent_commits_answer_whole_generations():
    """More reader threads than cores look up through snapshots while a
    writer commits two server sets in turn, with a short switch interval:
    every answer carries its generation and equals that generation's host
    oracle, or the lookup raises ``StaleRingError`` (bounded: ~1.5 s)."""
    sets = (_servers(10, 16), _servers(11, 16))
    store = tst.RingStore(sets[0], replica_points=10, device="cpu")
    keys = _t(_hashes(2048, seed=41))
    oracles = {}
    for s in (1, 0):
        store.update(add=sets[s], remove=sets[1 - s])
        oracles[s] = _generation_answer(store, "serve_lookup_fused", keys)
    stop = threading.Event()
    seen = {"answers": 0, "stale": 0, "torn": 0}
    lock = threading.Lock()

    def writer():
        while not stop.is_set():
            s = store.gen % 2  # even generations hold sets[0], odd ones sets[1]
            store.update(add=sets[1 - s], remove=sets[s])

    def reader():
        while not stop.is_set():
            ring, _, _ = store.snapshot()
            try:
                fused = tst.serve_lookup_fused(ring, keys).numpy()
            except tst.StaleRingError:
                with lock:
                    seen["stale"] += 1
                continue
            ok = np.array_equal(fused[:-1], oracles[int(fused[-1]) % 2])
            with lock:
                seen["answers" if ok else "torn"] += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range((os.cpu_count() or 2) + 2)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert seen["torn"] == 0, seen
    assert seen["answers"] > 0 and store.gen > 2, seen
