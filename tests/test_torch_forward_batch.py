"""The port's batched forwarding plane and quorum reads
(``ringpop_tpu_torch/forward/batch.py``), mirroring the JAX package's
``tests/test_forward_batch.py`` case for case against the port, and the
quorum chaos harness held to the JAX harness's result field for field.

The forwarding plane is host code over ``net.channel``'s in-process
network; ``quorum_chaos_run`` builds its ring and churn plan on the CPU.
A black-holed replica times out by design (``timeout=0.05``).
"""

import asyncio

import numpy as np
import pytest
import torch

from ringpop_tpu.forward.batch import quorum_chaos_run as jax_quorum_chaos_run

from ringpop_tpu_torch.forward.batch import (
    BatchForwarder,
    BlockRouter,
    HOPS_HEADER,
    MaxHopsExceededError,
    QuorumReader,
    quorum_chaos_run,
    quorum_size,
    rank_load,
    rank_of_hashes,
)
from ringpop_tpu_torch.net.channel import (
    CallError,
    LocalChannel,
    LocalNetwork,
    decode_array,
    encode_array,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _ring(t=32, n_servers=4, seed=0):
    rng = np.random.default_rng(seed)
    tokens = np.sort(rng.choice(2**32 - 2, size=t, replace=False).astype(np.uint32))
    owners = (np.arange(t) % n_servers).astype(np.int32)
    return tokens, owners


def _lookup_server(net, addr, tokens, owners, gen=0, calls=None):
    """One in-process serve node answering /lookup from (tokens, owners)."""
    chan = LocalChannel(net, addr, app="srv")

    async def handle(body, headers):
        if calls is not None:
            calls.append((addr, len(decode_array(body["h"], "<u4")), headers))
        h = decode_array(body["h"], "<u4")
        idx = np.searchsorted(tokens, h, side="left")
        idx = np.where(idx >= tokens.shape[0], 0, idx)
        return {"o": encode_array(owners[idx], "json", "<i4"), "gen": gen}

    chan.register("serve", "/lookup", handle)
    return chan


def test_quorum_size_is_majority_of_r_plus_one():
    assert quorum_size(1) == 1
    assert quorum_size(2) == 2
    assert quorum_size(3) == 2
    assert quorum_size(4) == 3
    assert quorum_size(5) == 3


def test_rank_of_hashes_equal_blocks_and_wrap():
    tokens = np.array([10, 20, 30, 40, 50, 60, 70, 80], np.uint32)
    ranks = rank_of_hashes(tokens, np.array([5, 25, 45, 65, 90], np.uint32), 4)
    # starts: idx 0, 2, 4, 6, wrap->0
    assert list(ranks) == [0, 1, 2, 3, 0]
    with pytest.raises(ValueError):
        rank_of_hashes(tokens[:6], np.array([5], np.uint32), 4)


def test_forward_batch_one_rpc_per_owner_and_counters():
    """The coalescing claim: forwarding B keys to one owner is ONE RPC
    with all B keys aboard, counted."""
    net = LocalNetwork()
    tokens, owners = _ring()
    calls = []
    _lookup_server(net, "s:1", tokens, owners, gen=3, calls=calls)
    client = LocalChannel(net, "c:1")
    fwd = BatchForwarder(client)

    hashes = np.arange(100, dtype=np.uint32) * 7919
    rows, gen = _run(fwd.forward_batch("s:1", hashes))
    assert gen == 3 and rows.shape == (100,)
    assert len(calls) == 1 and calls[0][1] == 100
    assert fwd.rpcs == 1 and fwd.keys_forwarded == 100
    # the forwarded + hop headers ride the frame
    hdrs = calls[0][2]
    assert hdrs.get("ringpop-forwarded") == "true"
    assert hdrs.get(HOPS_HEADER) == "1"


def test_forward_batch_retry_backoff_then_failure():
    net = LocalNetwork()
    client = LocalChannel(net, "c:1")
    fwd = BatchForwarder(
        client, max_retries=2, retry_delays=(0.001, 0.002), timeout=0.05
    )
    with pytest.raises(CallError):
        _run(fwd.forward_batch("dead:1", np.array([1], np.uint32)))
    assert fwd.rpcs == 3  # initial + 2 retries
    assert fwd.retries == 2 and fwd.batches_failed == 1


def test_forward_batch_max_hop_guard():
    net = LocalNetwork()
    client = LocalChannel(net, "c:1")
    fwd = BatchForwarder(client, max_hops=3)
    with pytest.raises(MaxHopsExceededError):
        _run(fwd.forward_batch("s:1", np.array([1], np.uint32), hops=3))
    assert fwd.rpcs == 0  # the guard fires before the wire


def test_block_router_splits_local_remote_one_rpc_per_owner():
    """B keys spanning 4 rank blocks from rank 0: local block answers
    in-process, the 3 remote blocks cost exactly 3 RPCs."""
    net = LocalNetwork()
    tokens, owners = _ring(t=32, n_servers=4)
    calls = []
    addrs = [f"s:{r}" for r in range(4)]
    for r in range(1, 4):
        _lookup_server(net, addrs[r], tokens, owners, gen=5, calls=calls)
    client = LocalChannel(net, "c:1")
    fwd = BatchForwarder(client)

    def local_lookup(h, n):
        idx = np.searchsorted(tokens, h, side="left")
        idx = np.where(idx >= tokens.shape[0], 0, idx)
        return owners[idx], 5

    router = BlockRouter(0, 4, lambda: tokens, local_lookup, addrs, fwd)
    rng = np.random.default_rng(1)
    hashes = rng.integers(0, 2**32, size=256, dtype=np.uint32)
    got, gens = _run(router.route(hashes))
    # oracle: every key answered as if one process owned the whole ring
    idx = np.searchsorted(tokens, hashes, side="left")
    idx = np.where(idx >= tokens.shape[0], 0, idx)
    assert np.array_equal(got, owners[idx])
    assert (gens == 5).all()
    ranks = rank_of_hashes(tokens, hashes, 4)
    n_remote_owners = len(set(ranks.tolist()) - {0})
    assert len(calls) == n_remote_owners  # O(owners), not O(keys)
    assert fwd.rpcs == n_remote_owners
    assert router.keys_local == int((ranks == 0).sum())
    assert router.keys_forwarded == int((ranks != 0).sum())


def test_block_router_handler_reforwards_with_hop_bump_and_loop_dies():
    """A router that believes another rank owns its own block: every
    forward lands back on itself, the hop counter climbs per forward, and
    the loop dies at the guard after EXACTLY max_hops RPCs (remote-handler
    errors are not retried — a loop must not cost 3^hops)."""
    net = LocalNetwork()
    tokens, owners = _ring(t=8, n_servers=2)
    addrs = ["a:1", "b:1"]
    chan = LocalChannel(net, addrs[0])
    fwd = BatchForwarder(chan, endpoint="/fwd", max_hops=4)

    def never_local(h, n):  # pragma: no cover - router never answers
        raise AssertionError("should not answer locally")

    # the router sits on a:1 but claims rank 1's block — every rank-0 key
    # forwards to addrs[0] == itself: a pure routing loop
    router = BlockRouter(1, 2, lambda: tokens, never_local, addrs, fwd)
    chan.register("serve", "/fwd", router.handler())

    async def drive():
        h = np.array([int(tokens[0]) - 1], np.uint32)  # rank 0's block
        with pytest.raises(CallError) as ei:
            await router.route(h)
        # the deepest hop's guard surfaces through the channel
        assert "routing loop" in str(ei.value)

    _run(drive())
    # hops 0..3 each cost one RPC; the guard at hops=4 fires pre-wire
    assert fwd.rpcs == 4


def test_block_router_multi_hop_preserves_per_key_generations():
    """A re-forwarded batch that mixes answerers at DIFFERENT ring
    generations must report each key's ACTUAL answering generation — the
    handler ships the per-key array, never a collapsed max."""
    net = LocalNetwork()
    tokens, owners = _ring(t=32, n_servers=4, seed=5)
    addrs = ["ra:1", "rb:1"]
    chans = [LocalChannel(net, a) for a in addrs]
    fwds = [BatchForwarder(c, endpoint="/fwd") for c in chans]

    def lookup_at(gen):
        def local_lookup(h, n):
            idx = np.searchsorted(tokens, h, side="left")
            idx = np.where(idx >= tokens.shape[0], 0, idx)
            return owners[idx], gen

        return local_lookup

    ra = BlockRouter(0, 2, lambda: tokens, lookup_at(5), addrs, fwds[0])
    rb = BlockRouter(1, 2, lambda: tokens, lookup_at(6), addrs, fwds[1])
    chans[0].register("serve", "/fwd", ra.handler())
    chans[1].register("serve", "/fwd", rb.handler())

    client = LocalChannel(net, "cl:1")
    cf = BatchForwarder(client, endpoint="/fwd")
    rng = np.random.default_rng(9)
    hashes = rng.integers(0, 2**32, size=128, dtype=np.uint32)
    ranks = rank_of_hashes(tokens, hashes, 2)
    assert (ranks == 0).any() and (ranks == 1).any()

    # client -> ra: ra answers its block at gen 5 and RE-FORWARDS rank-1
    # keys to rb (gen 6) — two answerers, one response
    rows, gens = _run(cf.forward_batch(addrs[0], hashes))
    assert isinstance(gens, np.ndarray)
    assert (gens[ranks == 0] == 5).all()
    assert (gens[ranks == 1] == 6).all()
    idx = np.searchsorted(tokens, hashes, side="left")
    idx = np.where(idx >= tokens.shape[0], 0, idx)
    assert np.array_equal(rows, owners[idx])


def test_quorum_reader_acks_and_agreement():
    net = LocalNetwork()
    servers = [f"q:{i}" for i in range(5)]
    from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens

    jt, jo = build_ring_tokens(servers, 8, device="cpu")
    tokens, owners = jt.numpy().astype(np.uint32), jo.numpy().astype(np.int32)
    for s in servers:
        _lookup_server(net, s, tokens, owners)
    client = LocalChannel(net, "c:9")
    fwd = BatchForwarder(client, max_retries=0, timeout=0.05)
    reader = QuorumReader(fwd, servers, r=3)
    hashes = np.arange(64, dtype=np.uint32) * 65537

    wave = _run(reader.quorum_wave(tokens, owners, 5, hashes))
    assert wave["acks_min"] == 3 and wave["quorum_ok_frac"] == 1.0
    assert wave["full_ack_frac"] == 1.0 and wave["answers_agree"]
    assert wave["rpcs"] <= 5  # one per owning server, never per key

    # kill a PRIMARY owner: quorum (2 of 3) must hold, full acks must dip
    from ringpop_tpu_torch.ops.ring_ops import host_lookup_n

    victim = int(host_lookup_n(tokens, owners, hashes, 1, 5)[0, 0])
    net.black_hole(servers[victim])
    wave2 = _run(reader.quorum_wave(tokens, owners, 5, hashes))
    assert wave2["quorum_ok_frac"] == 1.0 and wave2["acks_min"] == 2
    assert wave2["full_ack_frac"] < 1.0


def test_rank_load_matches_jax():
    from ringpop_tpu.forward.batch import rank_load as jax_rank_load

    tokens, _ = _ring(t=64, n_servers=4, seed=2)
    hashes = np.random.default_rng(4).integers(0, 2**32, size=999, dtype=np.uint32)
    for p in (1, 2, 4, 8):
        got = rank_load(tokens, hashes, p)
        assert np.array_equal(got, jax_rank_load(tokens, hashes, p)) and got.sum() == 999


def test_quorum_chaos_run_matches_jax():
    """The full harness at the JAX test's size: staggered owner kills with
    restarts — every wave, journal block and the score equal the JAX
    harness's; quorum holds throughout, every crash's full-replication
    recovery is observed, and the RPC pricing stays O(owners)."""
    rec = quorum_chaos_run(horizon=24, keys_per_tick=48, seed=0)
    want = jax_quorum_chaos_run(horizon=24, keys_per_tick=48, seed=0)
    assert rec == want  # the harness reads no wall clock
    assert rec["owners_killed"] and rec["quorum_held"] and rec["answers_agree"]
    assert rec["score"]["quorum_ok_frac_min"] == 1.0
    assert rec["score"]["quorum_acks_min"] >= rec["quorum"]
    ttd = rec["score"]["time_to_detect"]
    assert ttd and all(v is not None for _, v in ttd)
    assert rec["rpcs"] < rec["rpcs_naive"]


def test_quorum_chaos_run_plan_stays_on_the_host(monkeypatch):
    """The harness is host bookkeeping: it runs with no card visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = quorum_chaos_run(n_servers=5, replica_points=8, horizon=8, keys_per_tick=16, seed=1)
    assert rec["keys_read"] == 8 * 16 and rec["quorum_held"]
