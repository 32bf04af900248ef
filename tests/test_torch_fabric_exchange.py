"""The port's host-bridged DCN fabric (``ringpop_tpu_torch/parallel/fabric.py``,
its exchange half) against the JAX package's ``ringpop_tpu/parallel/fabric.py``.

* the window planners (``window_pieces``, ``plan_window``,
  ``plan_window_swing``) equal the JAX package's over a sweep of n, P and
  shifts, and refuse what it refuses;
* in-process ``Fabric``s over ``LocalKV`` in threads, fed the same arrays
  as JAX ``Fabric``s: the arrays received, ``wire_stats`` and
  ``codec_counts`` equal the JAX package's; async rounds equal sync
  rounds; the swing allgather equals the cyclic one;
* a dead peer, a stalled peer, ``close()`` with expectations queued, a
  closed fabric and a missed XOR-stream epoch reset fail as the JAX
  package's do (``tests/test_fabric_async.py``);
* ``DistributedKV`` on a ``torch.distributed.TCPStore``: values, timeouts,
  and a barrier whose name is used twice does not let the second use
  through on the first one's release.
"""

import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from ringpop_tpu.parallel import fabric as jf
from ringpop_tpu_torch.parallel import fabric as tf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_ranks(mod, nprocs, body, ns, timeout_ms=120_000, codec=True, join_s=60):
    """``body(fabric, rank)`` on ``nprocs`` threads, each a rank of one
    fabric of ``mod`` (the JAX package's or the port's) over a LocalKV;
    returns (results, errors) by rank."""
    kv = mod.LocalKV()
    out, errs = [None] * nprocs, [None] * nprocs

    def run(rank):
        try:
            with mod.Fabric(rank, nprocs, kv, namespace=ns, timeout_ms=timeout_ms, codec=codec) as fab:
                out[rank] = body(fab, rank)
        except BaseException as e:  # noqa: BLE001 - the test reads it
            errs[rank] = e

    ts = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(nprocs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(join_s)
    assert not any(t.is_alive() for t in ts), "a rank hung past the join budget"
    return out, errs


# -- the window planners --------------------------------------------------------


def test_window_planners_equal_the_jax_package():
    rng = np.random.default_rng(17)
    for nprocs in (1, 2, 3, 4, 8, 16):
        for n in sorted({nprocs * m for m in (1, 2, 3, 7, 16)}):
            b = n // nprocs
            for start in [0, 1, b - 1, b, n - 1, -1, -n - 3, 2 * n + 5, *rng.integers(-3 * n, 3 * n, 4).tolist()]:
                for length in sorted({0, 1, b, n}):
                    assert tf.window_pieces(start, length, n) == jf.window_pieces(start, length, n)
                assert tf.plan_window(start, b, n, nprocs) == jf.plan_window(start, b, n, nprocs)
                if nprocs >= 2 and not nprocs & (nprocs - 1):
                    assert tf.plan_window_swing(start % n, n, nprocs) == jf.plan_window_swing(start % n, n, nprocs)
    for a in [(0, 5, 3, 4), (3, 2, 0, 4), (0, 4, 4, 4), (7, 0, 7, 3)]:
        assert tf.intersect(*a) == jf.intersect(*a)


@pytest.mark.parametrize("call", [
    lambda m: m.plan_window(0, 25, 100, 3),
    lambda m: m.plan_window(7, 5, 17, 4),
    lambda m: m.plan_window(0, 4, 16, 0),
    lambda m: m.plan_window_swing(1, 12, 3),
    lambda m: m.plan_window_swing(1, 12, 1),
    lambda m: m.window_pieces(0, 65, 64),
], ids=["non-divisible", "non-divisible-2", "zero-procs", "swing-p3", "swing-p1", "over-long"])
def test_planner_refusals_match(call):
    with pytest.raises(ValueError) as want:
        call(jf)
    with pytest.raises(ValueError) as got:
        call(tf)
    assert str(got.value) == str(want.value)


# -- rounds, fed the same arrays as the JAX package's fabric -----------------------


def _payloads(rank, tick):
    rng = np.random.default_rng(13 + 31 * rank + tick)
    sparse = np.zeros((128, 4), np.uint32)
    sparse[rng.choice(128, 9, replace=False)] = rng.integers(1, 2**32, (9, 4), dtype=np.uint32)
    dense = rng.integers(1, 2**32, (32, 4), dtype=np.uint32)
    zeros = np.zeros((64, 2), np.uint32)
    patchy = np.zeros(512, np.uint32)
    patchy[100:140] = 7
    words = np.arange(8, dtype=np.int64) * (rank + 1)
    return [sparse, dense, zeros, patchy, words]


def _rounds_body(mode):
    """Three ticks of two rounds each (one streamed), then the swing and
    cyclic allgathers: ``mode`` "sync" blocks on each round, "async" holds
    both of a tick's handles before joining their receives."""

    def body(fab, rank):
        peers = [p for p in range(fab.nprocs) if p != rank]
        seen = []
        for tick in range(3):
            sends_a = {p: _payloads(rank, tick) for p in peers}
            stable = _payloads(rank, 100)[0].copy()
            stable[0, 0] = tick  # a stream whose payload recurs: the XOR codec engages
            sends_b = {p: [stable] for p in peers}
            if mode == "sync":
                a = fab.exchange(tick * 16, sends_a, peers)
                b = fab.exchange(tick * 16 + 1, sends_b, peers, stream="s")
            else:
                h1 = fab.exchange_async(tick * 16, sends_a, peers)
                h2 = fab.exchange_async(tick * 16 + 1, sends_b, peers, stream="s")
                a, b = h1.wait(join_sends=False), h2.wait(join_sends=False)
            seen.append([x.tobytes() for p in peers for x in a[p] + b[p]])
        gathered = []
        for tick, schedule in enumerate(("cyclic", "swing") if not fab.nprocs & (fab.nprocs - 1) else ("cyclic",)):
            got = fab.allgather(0x100 + tick * 16, np.arange(6, dtype=np.uint32) * (rank + 1) + tick,
                                stream="reduce", schedule=schedule)
            gathered.append([g.tobytes() for g in got])
        time.sleep(0.05)  # let the unjoined drains land before the counters are read
        return seen, gathered, fab.wire_stats(), fab.codec_epoch

    return body


@pytest.mark.parametrize("codec", [True, False], ids=["codec-on", "codec-off"])
@pytest.mark.parametrize("nprocs", [2, 3, 4])
def test_rounds_equal_the_jax_fabric_and_async_equals_sync(nprocs, codec):
    want, errs = run_ranks(jf, nprocs, _rounds_body("sync"), f"j{nprocs}{codec}", codec=codec)
    assert errs == [None] * nprocs, errs
    for mode in ("sync", "async"):
        got, errs = run_ranks(tf, nprocs, _rounds_body(mode), f"t{mode}{nprocs}{codec}", codec=codec)
        assert errs == [None] * nprocs, errs
        for rank in range(nprocs):
            assert got[rank][0] == want[rank][0], f"{mode}: received arrays differ on rank {rank}"
            assert got[rank][1] == want[rank][1], f"{mode}: allgather differs on rank {rank}"
            assert got[rank][2] == want[rank][2], f"{mode}: wire_stats differ on rank {rank}"
    if codec:
        assert want[0][2]["codec_counts"].get("xor", 0) >= 1, want[0][2]["codec_counts"]


def test_swing_allgather_equals_cyclic():
    def body_for(schedule):
        def body(fab, rank):
            return [[g.tobytes() for g in fab.allgather(t * 16, np.arange(8, dtype=np.uint32) * (rank + 1) + t,
                                                        stream="reduce", schedule=schedule)] for t in range(3)]
        return body

    cyc, e1 = run_ranks(tf, 4, body_for("cyclic"), "agc")
    swi, e2 = run_ranks(tf, 4, body_for("swing"), "ags")
    assert e1 == [None] * 4 and e2 == [None] * 4, (e1, e2)
    assert cyc == swi
    assert cyc[0][2][3] == (np.arange(8, dtype=np.uint32) * 4 + 2).tobytes()


def test_publish_lookup_and_barrier():
    def body(fab, rank):
        if rank == 0:
            fab.publish("words", np.arange(5, dtype=np.uint32) << 20)
        fab.barrier("published")
        return fab.lookup("words").tolist()

    out, errs = run_ranks(tf, 3, body, "pub")
    assert errs == [None] * 3, errs
    assert out == [(np.arange(5, dtype=np.uint32) << 20).tolist()] * 3


# -- failures, as the JAX package's fabric fails --------------------------------------


def test_two_dead_peers_aggregate_into_one_raise():
    def body(fab, rank):
        if rank in (1, 2):
            fab.close()
            return "died"
        if rank == 3:
            try:
                fab.exchange(0, {0: [np.arange(4, dtype=np.uint32)]}, [0])
            except tf.FabricError:
                pass
            return "peer3"
        time.sleep(0.3)
        peers = [1, 2, 3]
        fab.exchange(0, {p: [np.arange(4, dtype=np.uint32)] for p in peers}, peers)
        return "unreachable"

    out, errs = run_ranks(tf, 4, body, "twodead", timeout_ms=30_000)
    assert out[1] == "died" and out[2] == "died"
    e = errs[0]
    assert isinstance(e, tf.FabricError), e
    texts = [str(x) for x in getattr(e, "peer_errors", (e,))]
    assert any("peer 1" in t for t in texts) and any("peer 2" in t for t in texts), texts
    assert e.__context__ is not None


def test_dead_peer_fails_inflight_completion_promptly():
    def body(fab, rank):
        if rank == 1:
            assert fab.exchange(0, {0: [np.arange(3, dtype=np.uint32)]}, [0])[0][0].shape == (3,)
            fab.close()
            return "died"
        fab.exchange(0, {1: [np.arange(3, dtype=np.uint32)]}, [1])
        h = fab.exchange_async(1, {1: [np.arange(3, dtype=np.uint32)]}, [1])
        t0 = time.monotonic()
        with pytest.raises(tf.FabricPeerLost, match="peer 1"):
            h.wait()
        return time.monotonic() - t0

    out, errs = run_ranks(tf, 2, body, "killinflight", timeout_ms=30_000)
    assert errs == [None, None], errs
    assert out[1] == "died" and out[0] < 15, out


def test_stalled_peer_times_out():
    def body(fab, rank):
        if rank == 1:
            time.sleep(2.0)
            return "stalled"
        h = fab.exchange_async(7, {}, [1])
        with pytest.raises(tf.FabricTimeout, match="peer 1"):
            h.wait()
        return "timed-out"

    out, errs = run_ranks(tf, 2, body, "stall", timeout_ms=600)
    assert errs == [None, None], errs
    assert out == ["timed-out", "stalled"]


def test_close_fails_queued_expectations_and_refuses_rounds():
    def body(fab, rank):
        if rank == 1:
            time.sleep(0.4)
            return "idle"
        h1, h2 = fab.exchange_async(0, {}, [1]), fab.exchange_async(1, {}, [1])
        fab.close()
        t0 = time.monotonic()
        for h in (h1, h2):
            with pytest.raises(tf.FabricError):
                h.wait()
        with pytest.raises(tf.FabricError, match="closed"):
            fab.exchange_async(2, {}, [])
        return time.monotonic() - t0

    out, errs = run_ranks(tf, 2, body, "closeq", timeout_ms=10_000)
    assert errs == [None, None], errs
    assert out[1] == "idle" and out[0] < 5, out


def test_missed_epoch_reset_fails_loudly():
    """One rank resets its XOR streams and the other does not: the next
    streamed frame fails with the epoch desync, in both packages."""
    base = np.arange(1, 257, dtype=np.uint32).reshape(64, 4)  # dense: only the XOR of a one-word change pays
    nxt = base.copy()
    nxt[3, 1] += 1

    def body(fab, rank):
        peer = 1 - rank
        fab.exchange(0, {peer: [base]}, [peer], stream="s")
        if rank == 0:
            fab.reset_codec_state()
        try:
            fab.exchange(1, {peer: [nxt]}, [peer], stream="s")
        except (tf.FabricError, jf.FabricError) as e:
            return str(e)
        return "decoded"

    want, errs = run_ranks(jf, 2, body, "jepoch", timeout_ms=10_000)
    assert errs == [None, None], errs
    out, errs = run_ranks(tf, 2, body, "epoch", timeout_ms=10_000)
    assert errs == [None, None], errs
    assert out == want, (out, want)
    assert "epoch desync" in out[0], out  # the rank that reset refuses the stale XOR frame


def test_streamed_round_refuses_pre_encoded_items():
    def body(fab, rank):
        peer = 1 - rank
        enc = tf.encode_array(np.zeros(8, np.uint32))
        with pytest.raises(ValueError, match="pre-encoded"):
            fab.exchange_async(0, {peer: [enc]}, [], stream="s")
        return "refused"

    out, errs = run_ranks(tf, 2, body, "preenc")
    assert errs == [None, None] and out == ["refused", "refused"], errs


# -- DistributedKV on a TCPStore ---------------------------------------------------


@pytest.fixture
def store_server():
    server = torch.distributed.TCPStore("127.0.0.1", 0, is_master=True, timeout=timedelta(seconds=30),
                                        wait_for_workers=False)
    yield server
    del server


def _client(server):
    return tf.DistributedKV(address=f"127.0.0.1:{server.port}")


def test_distributed_kv_values_and_timeout(store_server):
    a, b = _client(store_server), _client(store_server)
    a.key_value_set("fabric/addr/0", "127.0.0.1:5000")
    assert b.blocking_key_value_get("fabric/addr/0", 1000) == "127.0.0.1:5000"
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        b.blocking_key_value_get("fabric/addr/1", 200)
    assert time.monotonic() - t0 < 10
    with pytest.raises(TimeoutError):
        a.barrier("lonely", 2, 200)


def test_distributed_kv_barrier_name_used_twice_does_not_pass_early(store_server):
    """Rank 1 reaches the second use of "b" a second late: rank 0's second
    wait lasts that second (the first use's release does not let it
    through), and both ranks leave both uses."""
    kvs = [_client(store_server) for _ in range(2)]
    waited = [None, None]

    def run(rank):
        kvs[rank].barrier("snapshot-done-16", 2, 20_000)
        if rank == 1:
            time.sleep(1.0)
        t0 = time.monotonic()
        kvs[rank].barrier("snapshot-done-16", 2, 20_000)
        waited[rank] = time.monotonic() - t0

    ts = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert waited[1] is not None and waited[0] is not None, waited
    assert waited[0] >= 0.9, f"the second use let rank 0 through after {waited[0]:.3f} s"


def test_fabric_over_distributed_kv(store_server):
    kvs = [_client(store_server) for _ in range(2)]
    out = [None, None]

    def run(rank):
        with tf.Fabric(rank, 2, kvs[rank], namespace="dkv") as fab:
            got = fab.allgather(0, np.arange(4, dtype=np.uint32) + rank)
            fab.barrier("done")
            out[rank] = [g.tolist() for g in got]

    ts = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert out[0] == out[1] == [[0, 1, 2, 3], [1, 2, 3, 4]]


def test_distributed_kv_needs_the_process_group():
    with pytest.raises(RuntimeError, match="init_distributed"):
        tf.DistributedKV()
