"""The port's live operations plane (``ringpop_tpu_torch/obs``) against the
JAX package's.

The cases of the JAX package's ``tests/test_obs.py`` (aggregation and the
Prometheus renderer, the tracer, the forwarding-plane spans, ``LiveOps``
single- and multi-rank, the flight recorder) and ``tests/test_closed_loop.py``
(rule hysteresis, controller dispatch and span parentage, the controller's
flight scope, the rank-restart rejoin, the ring store's drain and rescore
seams) run here against the port; the statsd reporter those files also
cover is not part of the port.  Then the same inputs go through both
packages: a rule engine and controller fed one alert history, and the
``zone_cut`` game day at simbench's non-full setting (n 64, horizon 48) —
digests, ``ttm_on``/``ttm_off``, and every alert and action record bar its
wall-clock key equal the JAX run's.  ``/metrics`` carries the sim counters
after a block.
"""

import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from ringpop_tpu_torch.obs import aggregate as agg
from ringpop_tpu_torch.obs import trace as tracemod
from ringpop_tpu_torch.obs.aggregate import AggregatingStats, render_prometheus
from ringpop_tpu_torch.obs.controller import OpsController
from ringpop_tpu_torch.obs.endpoint import LiveOps
from ringpop_tpu_torch.obs.flight import FlightRecorder, git_commit
from ringpop_tpu_torch.obs.rules import (
    FLEET,
    CrossRankSkew,
    RateOfChange,
    RuleEngine,
    Staleness,
    Threshold,
)
from ringpop_tpu_torch.parallel.fabric import Fabric, FabricPeerLost, LocalKV


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- AggregatingStats ---------------------------------------------------------


def test_aggregating_stats_counters_gauges_timings():
    st = agg.AggregatingStats()
    st.incr("a.count", 2)
    st.incr("a.count", 3)
    st.gauge("b.gauge", 1.5)
    st.gauge("b.gauge", 2.5)  # last value wins
    for v in (0.1, 0.2, 0.3):
        st.timing("c.time", v)
    snap = st.snapshot()
    assert snap["counters"]["a.count"] == 5
    assert snap["gauges"]["b.gauge"] == 2.5
    t = snap["timings"]["c.time"]
    assert t["count"] == 3 and t["min"] == 0.1 and t["max"] == 0.3
    assert abs(t["mean"] - 0.2) < 1e-9
    assert "a.count" in snap["rates_1m"]


def test_aggregating_stats_thread_safe_totals():
    st = agg.AggregatingStats()

    def pound():
        for _ in range(2000):
            st.incr("k", 1)

    ts = [threading.Thread(target=pound) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert st.snapshot()["counters"]["k"] == 8000


def test_prometheus_rendering_labels_and_aggregate():
    st = agg.AggregatingStats()
    st.incr("ringpop.sim.ping.send", 5)
    st.gauge("x-y.z", 2)
    snap = st.snapshot()
    txt = agg.render_prometheus({0: snap, 1: snap})
    assert '# TYPE ringpop_sim_ping_send counter' in txt
    assert 'ringpop_sim_ping_send{rank="0"} 5' in txt
    assert 'ringpop_sim_ping_send{rank="1"} 5' in txt
    # the unlabeled cross-rank aggregate
    assert "\nringpop_sim_ping_send 10" in txt
    # name sanitization: '-' and '.' both become '_'
    assert 'x_y_z{rank="0"} 2' in txt
    # single-rank rendering emits no aggregate duplicate
    solo = agg.render_prometheus({0: snap})
    assert "\nringpop_sim_ping_send 5\n" not in solo
    assert agg.merge_counter_totals({0: snap, 1: snap}) == {
        "ringpop.sim.ping.send": 10.0
    }


# -- Tracer -------------------------------------------------------------------


def test_tracer_sampling_is_pure_function_of_key_hash():
    records_a, records_b = [], []
    ta = tracemod.Tracer(records_a.append, sample=8)
    tb = tracemod.Tracer(records_b.append, sample=8)
    h = np.arange(256, dtype=np.uint32)
    assert (ta.sample_mask(h) == tb.sample_mask(h)).all()
    assert ta.sample_mask(h).sum() == 32
    sa = ta.begin("forward", h, salt=7)
    sb = tb.begin("forward", h, salt=7)
    assert sa.trace == sb.trace and sa.span == sb.span
    sa.finish()
    sb.finish()
    assert records_a[0]["keys"] == records_b[0]["keys"]
    assert records_a[0]["traces"] == records_b[0]["traces"]
    # an unsampled batch emits nothing at all
    assert ta.begin("forward", np.asarray([1, 2, 3], np.uint32)) is None
    assert records_a[0]["trace"] == tracemod.trace_id_of(0)


def test_tracer_header_round_trip_and_follow():
    records = []
    tr = tracemod.Tracer(records.append, sample=1, rank=3)
    sp = tr.begin("forward", np.asarray([42], np.uint32), hops=2)
    headers = {
        tracemod.TRACE_HEADER: sp.header_value(),
        "ringpop-hops": "2",
    }
    child = tr.follow(headers, "server", salt=1)
    assert child.trace == sp.trace
    assert child.record["parent"] == sp.span
    assert child.record["hops"] == 2
    # malformed/absent headers: no span, no raise
    assert tr.follow({}, "server") is None
    assert tr.follow({tracemod.TRACE_HEADER: "zzz"}, "server") is None
    assert tr.follow({tracemod.TRACE_HEADER: "12:34:56"}, "server") is None


def test_tracer_sink_failure_never_raises():
    def bad_sink(rec):
        raise RuntimeError("disk full")

    tr = tracemod.Tracer(bad_sink, sample=1)
    sp = tr.begin("forward", np.asarray([0], np.uint32))
    sp.finish()  # swallowed
    assert tr.spans_dropped == 1 and tr.spans_emitted == 0


def test_span_chain_reconstruction_orders_parent_first():
    records = []
    tr = tracemod.Tracer(records.append, sample=1)
    root = tr.begin("route", np.asarray([9], np.uint32))
    mid = tr.begin("forward", np.asarray([9], np.uint32), parent=root.span,
                   salt=1)
    leaf = tr.begin("handle", np.asarray([9], np.uint32), parent=mid.span,
                    salt=2)
    # finish out of order: chain ordering comes from parent links
    leaf.finish()
    root.finish()
    mid.finish()
    ch = tracemod.chain(records, tracemod.trace_id_of(9))
    assert [s["leg"] for s in ch] == ["route", "forward", "handle"]


# -- forwarding-plane spans (route -> forward -> handle, hop parity) ----------


def _lookup_fixture(n_servers=2, points=8):
    from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens

    servers = [f"10.31.0.{i}:3000" for i in range(n_servers)]
    toks, owns = build_ring_tokens(servers, points, device="cpu")
    tokens = np.asarray(toks, np.uint32)
    owners = np.asarray(owns, np.int32)

    def lookup(h, n):
        idx = np.searchsorted(tokens, np.asarray(h, np.uint32), side="left")
        idx = np.where(idx >= tokens.shape[0], 0, idx)
        return np.asarray(owners[idx], np.int32), 7

    return servers, tokens, owners, lookup


def test_forwarded_span_chain_hops_match_header():
    """The acceptance join: a forwarded key's chain reconstructs
    frontend route -> forward RPC -> receive-side handle from the
    records alone, and every forward span's ``hops`` equals the
    ``ringpop-hops`` value its downstream server/handle spans saw."""
    import asyncio

    from ringpop_tpu_torch.forward.batch import BatchForwarder, BlockRouter
    from ringpop_tpu_torch.net.channel import LocalChannel, LocalNetwork

    servers, tokens, owners, lookup = _lookup_fixture()
    net = LocalNetwork(seed=0)
    records = []
    tr = tracemod.Tracer(records.append, sample=1)
    for rank, addr in enumerate(servers):
        chan = LocalChannel(net, addr, app="serve")
        chan.tracer = tr
        router = BlockRouter(
            rank, len(servers), lambda: tokens, lookup, servers,
            BatchForwarder(chan, tracer=tr),
        )
        chan.register("serve", "/lookup", router.handler())
    client = LocalChannel(net, "10.31.0.99:1", app="cli")
    frontend = BlockRouter(
        0, len(servers), lambda: tokens, lookup, servers,
        BatchForwarder(client, tracer=tr),
    )
    hashes = np.asarray([0x10, 0xF0000000, 0x7F000000], np.uint32)

    loop = asyncio.new_event_loop()
    try:
        o, g = loop.run_until_complete(frontend.route(hashes, n=1))
    finally:
        loop.close()
    assert (g == 7).all()

    from ringpop_tpu_torch.forward.batch import rank_of_hashes

    ranks = rank_of_hashes(tokens, hashes, len(servers))
    assert (ranks != 0).any(), "fixture must forward at least one key"
    for key, owner_rank in zip(hashes.tolist(), ranks.tolist()):
        ch = tracemod.chain(records, tracemod.trace_id_of(key))
        legs = [s["leg"] for s in ch]
        assert legs[0] == "route" and ch[0]["parent"] is None
        if owner_rank != 0:
            # a cross-block key must show the full forwarded chain
            assert "forward" in legs and "handle" in legs, legs
        for s in ch:
            if s["leg"] != "forward":
                continue
            kids = [k for k in ch if k.get("parent") == s["span"]
                    and k["leg"] in ("server", "handle")]
            assert kids, f"forward span {s['span']} has no downstream record"
            for k in kids:
                assert k["hops"] == s["hops"], (s, k)


# -- LiveOps ------------------------------------------------------------------


def _scrape(addr, path):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=5) as r:
        return r.read().decode()


def test_liveops_single_rank_endpoints():
    ops = LiveOps(0, 1)
    ops.stats.incr("ringpop.sim.ping.send", 4)
    ops.progress(16, 64, last_checkpoint_tick=8)
    addr = ops.serve()
    try:
        m = _scrape(addr, "/metrics")
        assert 'ringpop_sim_ping_send{rank="0"} 4' in m
        assert 'ringpop_obs_progress_ticks_done{rank="0"} 16' in m
        h = json.loads(_scrape(addr, "/healthz"))
        assert h["ok"] and h["rank"] == 0 and h["ranks"]["0"]["live"]
        p = json.loads(_scrape(addr, "/progress"))
        assert p["ranks"]["0"] == {
            "ticks_done": 16, "horizon": 64, "last_checkpoint_tick": 8,
        }
        # unknown path is a 404, not a crash
        with pytest.raises(urllib.error.HTTPError):
            _scrape(addr, "/nope")
    finally:
        ops.close()


def test_liveops_cross_rank_aggregation_and_liveness():
    kv = LocalKV()
    opses = [None, None]
    errs = [None, None]

    def worker(rank):
        try:
            ops = LiveOps(rank, 2, kv=kv, namespace="obs-agg-t")
            opses[rank] = ops
            ops.stats.incr("ringpop.sim.ping.send", 10 * (rank + 1))
            ops.progress(4 + rank, 32)
            for _ in range(3):
                ops.sync()
                time.sleep(0.01)
        except BaseException as e:  # noqa: BLE001
            errs[rank] = e

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert errs == [None, None], errs
    addr = opses[0].serve()
    try:
        m = _scrape(addr, "/metrics")
        assert 'ringpop_sim_ping_send{rank="0"} 10' in m
        assert 'ringpop_sim_ping_send{rank="1"} 20' in m
        assert "\nringpop_sim_ping_send 30" in m
        p = json.loads(_scrape(addr, "/progress"))
        assert p["ranks"]["0"]["ticks_done"] == 4
        assert p["ranks"]["1"]["ticks_done"] == 5
        h = json.loads(_scrape(addr, "/healthz"))
        assert set(h["ranks"]) == {"0", "1"} and h["ok"]
    finally:
        for o in opses:
            o.close()


def test_liveops_sync_never_raises_after_peer_death():
    """A dead peer degrades the plane (liveness shows it) but sync on
    the survivor keeps returning — the ops plane must never take the
    sweep down."""
    kv = LocalKV()
    opses = [None, None]
    barrier = threading.Barrier(2, timeout=30)

    def worker(rank):
        ops = LiveOps(rank, 2, kv=kv, namespace="obs-death-t",
                      timeout_ms=2_000)
        opses[rank] = ops
        barrier.wait()
        ops.sync()
        if rank == 1:
            ops.close()  # rank 1 dies abruptly after one round

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    ops0 = opses[0]
    deadline = time.monotonic() + 10
    # keep syncing; eventually the dead peer surfaces in health, and no
    # sync call may raise
    while time.monotonic() < deadline:
        ops0.sync()
        h = ops0.health()
        if not h["ranks"].get("1", {"live": True})["live"] or h["degraded"]:
            break
        time.sleep(0.05)
    h = ops0.health()
    assert (not h["ranks"].get("1", {"live": True})["live"]) or h["degraded"]
    ops0.close()


# -- FlightRecorder -----------------------------------------------------------


def test_flight_recorder_ring_bounds_and_dump_schema(tmp_path):
    rec = FlightRecorder(capacity=8, rank=2,
                         path=str(tmp_path / "flight.jsonl"))
    for i in range(20):
        rec.record({"kind": "block", "tick": i})
    kept = rec.records()
    assert len(kept) == 8 and kept[-1]["tick"] == 19 and kept[0]["tick"] == 12
    assert [r["flight_seq"] for r in kept] == list(range(12, 20))
    path = rec.dump("unit_test", error=RuntimeError("boom"))
    lines = [json.loads(x) for x in open(path)]
    head = lines[0]
    assert head["kind"] == "flight_header"
    assert head["reason"] == "unit_test" and "boom" in head["error"]
    assert head["rank"] == 2 and head["dropped"] == 12
    assert head["git_commit"] == git_commit()
    assert [r["tick"] for r in lines[1:]] == list(range(12, 20))
    # second dump is suppressed (first failure wins) unless forced
    assert rec.dump("again") is None
    assert rec.dump("forced", force=True) is not None


def test_flight_recorder_dumps_on_fabric_peer_lost(tmp_path):
    """Kill one rank's fabric mid-exchange: the surviving rank's
    FabricPeerLost must trigger the installed recorder's dump."""
    rec = FlightRecorder(capacity=16, rank=0,
                         path=str(tmp_path / "peer_lost.jsonl"))
    rec.install(fabric=True, excepthook=False, threads=False)
    try:
        kv = LocalKV()
        fabs = [None, None]
        ready = threading.Barrier(2, timeout=30)

        def run(rank):
            fab = Fabric(rank, 2, kv, namespace="obs-fl-t", timeout_ms=5_000)
            fabs[rank] = fab
            ready.wait()
            if rank == 1:
                time.sleep(0.1)
                fab.close()  # dies without sending
                return
            rec.record({"kind": "block", "tick": 99})
            with pytest.raises(FabricPeerLost):
                fab.exchange(7, {1: [np.ones(4, np.uint32)]}, [1])
            fab.close()

        ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert rec.dumped is not None
        lines = [json.loads(x) for x in open(rec.dumped)]
        assert lines[0]["reason"] == "fabric:FabricPeerLost"
        assert lines[-1]["kind"] == "block" and lines[-1]["tick"] == 99
    finally:
        rec.uninstall()


def test_flight_recorder_dumps_on_thread_exception(tmp_path):
    rec = FlightRecorder(capacity=4, rank=1,
                         path=str(tmp_path / "thread.jsonl"))
    rec.install(fabric=False, excepthook=False, threads=True)
    try:
        rec.record({"kind": "block", "tick": 5})

        def boom():
            raise ValueError("mid-sweep crash")

        t = threading.Thread(target=boom)
        t.start()
        t.join(10)
        assert rec.dumped is not None
        lines = [json.loads(x) for x in open(rec.dumped)]
        assert lines[0]["reason"] == "uncaught_thread_exception"
        assert "mid-sweep crash" in lines[0]["error"]
    finally:
        rec.uninstall()


def test_git_commit_matches_git(tmp_path):
    import subprocess

    got = git_commit()
    assert got and len(got) == 40
    try:
        want = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=str(tmp_path.parents[0] / ".."), timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        pytest.skip("git unavailable")
    # run against the repo root, not tmp_path
    import ringpop_tpu_torch

    repo = ringpop_tpu_torch.__file__.rsplit("/", 2)[0]
    want = subprocess.run(
        ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
        cwd=repo, timeout=10,
    )
    if want.returncode != 0:
        pytest.skip("not a git checkout")
    assert got == want.stdout.strip()
    # non-repo directory: honest None, no raise
    assert git_commit(str(tmp_path)) is None


def test_span_ids_distinct_across_route_and_quorum_paths_default_salts():
    """Review fix (r20): the same key forwarded to the same dest at the
    same hop level through TWO upstream paths (frontend route, then a
    quorum wave) must emit fully distinct span ids at DEFAULT salts —
    the parent rides the id — and both chains keep their own
    downstream server/handle records."""
    import asyncio

    from ringpop_tpu_torch.forward.batch import (
        BatchForwarder,
        BlockRouter,
        QuorumReader,
    )
    from ringpop_tpu_torch.net.channel import LocalChannel, LocalNetwork

    servers, tokens, owners, lookup = _lookup_fixture()
    net = LocalNetwork(seed=0)
    records = []
    tr = tracemod.Tracer(records.append, sample=1)
    for rank, addr in enumerate(servers):
        chan = LocalChannel(net, addr, app="serve")
        chan.tracer = tr
        router = BlockRouter(
            rank, 2, lambda: tokens, lookup, servers,
            BatchForwarder(chan, tracer=tr),
        )
        chan.register("serve", "/lookup", router.handler())
    client = LocalChannel(net, "10.31.0.98:1", app="cli")
    cfwd = BatchForwarder(client, tracer=tr)
    frontend = BlockRouter(0, 2, lambda: tokens, lookup, servers, cfwd)
    reader = QuorumReader(cfwd, servers, r=2)
    key = np.asarray([0xF0000000], np.uint32)  # remote-owned

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(frontend.route(key, n=1))
        loop.run_until_complete(
            reader.quorum_wave(tokens, owners, 2, key)  # default salt
        )
    finally:
        loop.close()
    ids = [s["span"] for s in records]
    assert len(ids) == len(set(ids)), (
        f"span id collision: {[(s['leg'], s['span']) for s in records]}"
    )
    ch = tracemod.chain(records, tracemod.trace_id_of(0xF0000000))
    forwards = [s for s in ch if s["leg"] == "forward"]
    assert len(forwards) >= 2  # the route path AND a quorum read
    for s in forwards:
        kids = [k for k in ch if k.get("parent") == s["span"]
                and k["leg"] in ("server", "handle")]
        assert kids and all(k["hops"] == s["hops"] for k in kids)


def test_obs_fabric_failures_do_not_burn_the_flight_dump(tmp_path):
    """Review fix (r20): a ``notify_failures=False`` fabric (the obs
    plane's side channel) must NOT trigger the global failure hooks —
    its peer losses/timeouts are routine rank skew, and the flight
    recorder's once-per-process dump belongs to ENGINE fabric failures."""
    rec = FlightRecorder(capacity=8, rank=0,
                         path=str(tmp_path / "quiet.jsonl"))
    rec.install(fabric=True, excepthook=False, threads=False)
    try:
        kv = LocalKV()
        ready = threading.Barrier(2, timeout=30)

        def run(rank):
            fab = Fabric(rank, 2, kv, namespace="obs-quiet-t",
                         timeout_ms=5_000, notify_failures=False)
            ready.wait()
            if rank == 1:
                time.sleep(0.1)
                fab.close()
                return
            with pytest.raises(FabricPeerLost):
                fab.exchange(9, {1: [np.ones(2, np.uint32)]}, [1])
            fab.close()

        ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert rec.dumped is None, "quiet fabric burned the flight dump"
    finally:
        rec.uninstall()

def _gauges(**kv) -> dict:
    return {"gauges": dict(kv)}


def _counters(**kv) -> dict:
    return {"counters": dict(kv)}


# -- rule hysteresis ----------------------------------------------------------


def test_threshold_hold_window_and_band():
    out = []
    eng = RuleEngine(
        [Threshold(id="hot", key="g", op=">", firing=10.0, clear=5.0,
                   hold=2, hold_clear=2)],
        sink=out.append,
    )
    # one hot evaluation is not enough (hold=2)
    assert eng.evaluate({0: _gauges(g=12.0)}) == []
    fired = eng.evaluate({0: _gauges(g=13.0)})
    assert [r["state"] for r in fired] == ["firing"]
    assert fired[0]["rule"] == "hot" and fired[0]["about_rank"] == FLEET
    assert fired[0]["kind"] == "alert" and fired[0]["parent"] is None
    # inside the hysteresis band (5 < v <= 10): neither clears nor refires
    assert eng.evaluate({0: _gauges(g=7.0)}) == []
    assert eng.state("hot") is True
    # below the clear edge, but hold_clear=2 needs two in a row
    assert eng.evaluate({0: _gauges(g=3.0)}) == []
    cleared = eng.evaluate({0: _gauges(g=3.0)})
    assert [r["state"] for r in cleared] == ["clear"]
    assert eng.state("hot") is False
    # the clear shares its firing's trace: one chain() pulls the episode
    assert cleared[0]["trace"] == fired[0]["trace"]
    assert out == fired + cleared and eng.alerts_emitted == 2


def test_alert_spans_are_rerun_deterministic():
    def run():
        eng = RuleEngine(
            [Threshold(id="hot", key="g", firing=1.0)], sink=lambda r: None
        )
        recs = []
        for v in (2.0, 0.0, 2.0):
            recs.extend(eng.evaluate({0: _gauges(g=v)}))
        return [(r["trace"], r["span"], r["state"]) for r in recs]

    first, second = run(), run()
    assert first == second and len(first) == 3
    # the second firing is a NEW episode: distinct trace from the first
    assert first[0][0] != first[2][0]


def test_rate_of_change_spike_mode_self_calibrating():
    eng = RuleEngine(
        [RateOfChange(id="spike", key="c", spike_ratio=4.0, floor=1.0,
                      per_rank=False, hold=1)],
        sink=lambda r: None,
    )
    # baseline deltas of 10/eval: obs #1 has no delta, #2 no prev delta,
    # #3 is the first ratio (1.0 — quiet)
    for v in (0.0, 10.0, 20.0):
        assert eng.evaluate({0: _counters(c=v)}) == []
    # a 8x step in the delta fires regardless of the absolute level
    fired = eng.evaluate({0: _counters(c=100.0)})
    assert [r["state"] for r in fired] == ["firing"]
    assert fired[0]["value"] == pytest.approx(8.0)
    # back to baseline: ratio collapses, the alert clears
    cleared = eng.evaluate({0: _counters(c=110.0)})
    assert [r["state"] for r in cleared] == ["clear"]


def test_rate_of_change_stall_band():
    eng = RuleEngine(
        [RateOfChange(id="stall", key="c", low=1.0, per_rank=True, hold=1)],
        sink=lambda r: None,
    )
    assert eng.evaluate({1: _counters(c=100.0)}) == []
    assert eng.evaluate({1: _counters(c=110.0)}) == []  # delta 10: fine
    fired = eng.evaluate({1: _counters(c=110.0)})  # delta 0: stalled
    assert [(r["state"], r["about_rank"]) for r in fired] == [("firing", 1)]


def test_cross_rank_skew_names_the_skewed_rank():
    eng = RuleEngine(
        [CrossRankSkew(id="skew", key="load", ratio=1.5, hold=1)],
        sink=lambda r: None,
    )
    # one rank reporting -> below min_ranks, no observation at all
    assert eng.evaluate({0: _gauges(load=10.0)}) == []
    fired = eng.evaluate({0: _gauges(load=10.0), 1: _gauges(load=40.0)})
    assert [(r["state"], r["about_rank"]) for r in fired] == [("firing", 1)]
    assert fired[0]["value"] == pytest.approx(40.0 / 25.0)
    balanced = {0: _gauges(load=24.0), 1: _gauges(load=26.0)}
    cleared = eng.evaluate(balanced)
    assert [(r["state"], r["about_rank"]) for r in cleared] == [("clear", 1)]


def test_staleness_skips_self_and_holds():
    eng = RuleEngine([Staleness(id="stale", hold=2)], sink=lambda r: None)
    health = {"ranks": {
        "0": {"live": True, "self": True},
        "1": {"live": False},
    }}
    assert eng.evaluate({}, health=health) == []
    fired = eng.evaluate({}, health=health)
    assert [(r["state"], r["about_rank"]) for r in fired] == [("firing", 1)]
    # the self entry never becomes a subject
    assert eng.state("stale", 0) is None


def test_engine_isolates_broken_rules_and_rejects_dup_ids():
    class Broken(Threshold):
        def observe(self, ctx):
            raise RuntimeError("boom")

    eng = RuleEngine(
        [Broken(id="bad", key="g", firing=0.0),
         Threshold(id="good", key="g", firing=1.0)],
        sink=lambda r: None,
    )
    fired = eng.evaluate({0: _gauges(g=5.0)})
    assert [r["rule"] for r in fired] == ["good"]
    with pytest.raises(ValueError, match="duplicate rule ids"):
        RuleEngine(
            [Threshold(id="x", key="g"), Threshold(id="x", key="h")],
            sink=lambda r: None,
        )


def test_engine_counts_sink_failures_without_raising():
    def bad_sink(rec):
        raise OSError("disk gone")

    eng = RuleEngine([Threshold(id="t", key="g", firing=1.0)], sink=bad_sink)
    fired = eng.evaluate({0: _gauges(g=5.0)})
    assert len(fired) == 1  # the record still comes back to the caller
    assert eng.alerts_dropped == 1 and eng.alerts_emitted == 0


# -- controller dispatch + span parentage -------------------------------------


class _StubStore:
    def __init__(self, fail=False):
        self.fail = fail
        self.gen = 0
        self.drained = []
        self.rescored = 0

    def drain(self, servers):
        if self.fail:
            raise RuntimeError("ring wedged")
        self.gen += 1
        self.drained.extend(servers)
        return {"gen": self.gen, "removed": list(servers), "drain": True}

    def rescore_placement(self):
        self.gen += 1
        self.rescored += 1
        return {"gen": self.gen, "rescored": True,
                "placement": {"movement_chosen": 0.25}}


def _one_alert(journal, rule_id="spike", subject=FLEET):
    eng = RuleEngine(
        [RateOfChange(id=rule_id, key="c", spike_ratio=4.0, per_rank=False,
                      hold=1)],
        sink=journal.append,
    )
    for v in (0.0, 10.0, 20.0):
        eng.evaluate({0: _counters(c=v)})
    fired = eng.evaluate({0: _counters(c=200.0)})
    assert len(fired) == 1
    return fired


def test_controller_drain_effect_chain_reconstructs():
    journal: list[dict] = []
    store = _StubStore()
    ctl = OpsController(
        sink=journal.append,
        policy={"spike": "drain"},
        ring_store=store,
        server_of=lambda subject: "z0",
        drain_probe=lambda server: 0,
    )
    alerts = _one_alert(journal)
    acts = ctl.on_alerts(alerts, tick=24)
    assert [a["action"] for a in acts] == ["drain", "effect"]
    drain, effect = acts
    alert = alerts[0]
    # the action joins the ALERT's trace and parents on its span;
    # the effect parents on the action
    assert drain["trace"] == alert["trace"]
    assert drain["parent"] == alert["span"]
    assert effect["parent"] == drain["span"] and effect["of"] == "drain"
    assert drain["ok"] and drain["detail"] == {"server": "z0", "gen": 1}
    assert effect["ok"] and effect["detail"]["share"] == 0
    assert store.drained == ["z0"]
    # chain() over the raw journal: alert first, then action, then effect
    ch = tracemod.chain(journal, alert["trace"])
    assert [(r["kind"], r.get("action")) for r in ch] == [
        ("alert", None), ("action", "drain"), ("action", "effect"),
    ]
    # an already-drained subject does not re-drain (nor does cooldown
    # permit an immediate repeat)
    assert ctl.on_alerts(alerts, tick=25) == []
    assert store.gen == 1 and ctl.actions_taken == 1


def test_controller_ignores_clears_and_unpoliced_rules():
    journal: list[dict] = []
    ctl = OpsController(
        sink=journal.append, policy={"spike": "drain"},
        ring_store=_StubStore(), server_of=lambda s: "z0",
    )
    clear = [{"kind": "alert", "rule": "spike", "state": "clear",
              "about_rank": FLEET, "trace": 1, "span": 2}]
    other = [{"kind": "alert", "rule": "unmapped", "state": "firing",
              "about_rank": FLEET, "trace": 3, "span": 4}]
    assert ctl.on_alerts(clear, tick=1) == []
    assert ctl.on_alerts(other, tick=2) == []
    assert journal == [] and ctl.actions_taken == 0


def test_controller_dgro_rescore_and_resize_dispatch():
    journal: list[dict] = []
    store = _StubStore()
    resized = []

    def resize(rank):
        resized.append(rank)
        return {"target_p": 1}

    ctl = OpsController(
        sink=journal.append,
        policy={"skew": "dgro_rescore", "stale": "resize"},
        ring_store=store,
        resize=resize,
        cooldown=1,
    )
    skew = [{"kind": "alert", "rule": "skew", "state": "firing",
             "about_rank": 1, "trace": 11, "span": 12}]
    stale = [{"kind": "alert", "rule": "stale", "state": "firing",
              "about_rank": 1, "trace": 21, "span": 22}]
    a1 = ctl.on_alerts(skew, tick=8)
    a2 = ctl.on_alerts(stale, tick=16)
    assert [a["action"] for a in a1 + a2] == ["dgro_rescore", "resize"]
    assert a1[0]["ok"] and a1[0]["detail"]["placement"] == {
        "movement_chosen": 0.25
    }
    assert store.rescored == 1
    assert a2[0]["ok"] and a2[0]["detail"] == {"target_p": 1}
    assert resized == [1]
    assert ctl.actions_taken == 2 and len(journal) == 2
    with pytest.raises(ValueError, match="unknown actions"):
        OpsController(sink=journal.append, policy={"x": "reboot_the_moon"})


def test_controller_rejects_unknown_policy_subjects_cooldown_per_subject():
    journal: list[dict] = []
    ctl = OpsController(
        sink=journal.append, policy={"skew": "dgro_rescore"},
        ring_store=_StubStore(), cooldown=1000,
    )
    mk = lambda rank: [{  # noqa: E731
        "kind": "alert", "rule": "skew", "state": "firing",
        "about_rank": rank, "trace": rank * 10, "span": rank * 10 + 1,
    }]
    assert len(ctl.on_alerts(mk(1), tick=1)) == 1
    assert ctl.on_alerts(mk(1), tick=2) == []  # cooldown holds per subject
    assert len(ctl.on_alerts(mk(2), tick=3)) == 1  # other subject free


# -- failing mitigation: the controller's OWN flight scope --------------------


def test_failed_mitigation_dumps_controller_scope_only(tmp_path):
    rec = FlightRecorder(capacity=16, rank=0,
                         path=str(tmp_path / "flight.jsonl"))
    rec.event("warmup", n=1)
    journal: list[dict] = []
    ctl = OpsController(
        sink=journal.append, policy={"spike": "drain"},
        ring_store=_StubStore(fail=True), server_of=lambda s: "z0",
        recorder=rec, cooldown=1,
    )
    alerts = _one_alert(journal)
    acts = ctl.on_alerts(alerts, tick=24)
    assert len(acts) == 1 and not acts[0]["ok"]
    assert "RuntimeError: ring wedged" in acts[0]["error"]
    assert ctl.actions_failed == 1
    # exactly one dump, controller-scoped, naming the failed action —
    # and the ENGINE once-per-process slot is untouched
    ctl_dump = tmp_path / "flight-controller.jsonl"
    assert rec.dumps == {"controller": str(ctl_dump)}
    assert rec.dumped is None
    lines = ctl_dump.read_text().splitlines()
    header = json.loads(lines[0])
    assert header["kind"] == "flight_header"
    assert header["scope"] == "controller"
    assert header["reason"] == "controller:drain"
    assert "RuntimeError" in header["error"]
    # a second failing mitigation does not re-dump (once per scope)
    more = _one_alert(journal, subject=FLEET)
    ctl._drained.clear()
    ctl.on_alerts(more, tick=32)
    assert list(rec.dumps) == ["controller"]
    # the engine crash dump still fires afterwards, to its own file
    engine = rec.dump("fabric:FabricPeerLost", error=OSError("peer gone"))
    assert engine == str(tmp_path / "flight.jsonl")
    assert rec.dumped == engine
    eh = json.loads((tmp_path / "flight.jsonl").read_text().splitlines()[0])
    assert eh["scope"] == "engine" and eh["reason"] == "fabric:FabricPeerLost"


# -- /metrics timing exposition (satellite: real summaries) -------------------


def test_prometheus_timing_summary_exposition():
    st = AggregatingStats()
    for v in (0.010, 0.020, 0.030):
        st.timing("ringpop.serve.lookup-us", v)
    text = render_prometheus({0: st.snapshot()})
    assert "# TYPE ringpop_serve_lookup_us summary" in text
    # the reservoir caveat must ride the family, and no _sum may exist
    assert "reservoir-sampled quantiles" in text
    assert "ringpop_serve_lookup_us_sum" not in text
    assert 'ringpop_serve_lookup_us{rank="0",quantile="0.5"}' in text
    assert 'ringpop_serve_lookup_us{rank="0",quantile="0.99"}' in text
    assert 'ringpop_serve_lookup_us_count{rank="0"} 3' in text
    # aux stats stay available as explicit gauges
    assert "# TYPE ringpop_serve_lookup_us_mean gauge" in text


# -- LiveOps rank restart: stale -> live over the rejoin path -----------------


def _sync_until(opses, pred, rounds=300, pause=0.02):
    for _ in range(rounds):
        for ops in opses:
            ops.sync()
        if pred():
            return True
        time.sleep(pause)
    return False


def test_liveops_rank_restart_rejoins_same_rank_id():
    kv = LocalKV()
    ns = "obs-rejoin-t"
    built: dict[int, LiveOps] = {}

    def boot(rank):
        built[rank] = LiveOps(rank, 2, kv=kv, namespace=ns,
                              timeout_ms=10_000, stale_s=120.0)

    ts = [threading.Thread(target=boot, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    ops0, ops1 = built[0], built[1]
    ops1b = None
    try:
        assert _sync_until(
            [ops1, ops0],
            lambda: ops0.health()["ranks"].get("1", {}).get("live") is True,
        ), "initial bring-up never went live"

        # rank 1 dies abruptly: its socket closes, rank 0's pending
        # obs rounds fail, /healthz flips the rank to live=false
        ops1.close()
        assert _sync_until(
            [ops0],
            lambda: ops0.health()["ranks"]["1"]["live"] is False,
        ), "rank 0 never marked the dead rank stale"

        # the restart: SAME rank id, rejoin=True — the fabric advertises
        # a rejoin listener instead of redoing collective bring-up, and
        # rank 0 dials it from sync().  stale -> live is the pin.
        ops1b = LiveOps(1, 2, kv=kv, namespace=ns,
                        timeout_ms=10_000, stale_s=120.0, rejoin=True)
        assert _sync_until(
            [ops1b, ops0],
            lambda: ops0.health()["ranks"]["1"]["live"] is True,
        ), "restarted rank never transitioned back to live"

        # and the data plane works again: fresh counters flow to rank 0
        ops1b.stats.incr("ringpop.test.rejoin", 7)
        assert _sync_until(
            [ops1b, ops0],
            lambda: ops0.snapshots().get(1, {}).get("counters", {})
            .get("ringpop.test.rejoin") == 7,
        ), "restarted rank's snapshots never reached rank 0"
        assert ops0.health()["ok"] is True
    finally:
        for ops in (ops0, ops1, ops1b):
            if ops is not None:
                ops.close()


# -- the serve/forward seams the controller drives ----------------------------


def test_ring_store_drain_commit_and_record():
    from ringpop_tpu_torch.serve.state import RingStore

    events: list[dict] = []
    store = RingStore(["z0", "z1", "z2", "z3"], replica_points=16, device="cpu",
                      on_update=events.append)
    g0 = store.gen
    rec = store.drain(["z1"])
    assert rec is not None and rec["gen"] == g0 + 1
    assert rec["drain"] is True and rec["removed"] == ["z1"]
    # the listener saw the SAME stamped record (stamped before on_update)
    assert events[-1]["drain"] is True
    # the drained server really routes away
    keys = [f"k{i}" for i in range(256)]
    assert "z1" not in set(store.ring.lookup_batch(keys))
    # draining a server that is not in the ring is a no-op
    assert store.drain(["nope"]) is None
    assert store.gen == g0 + 1


def test_ring_store_rescore_only_under_dgro():
    from ringpop_tpu_torch.serve.state import RingStore

    plain = RingStore(["a", "b"], replica_points=8, device="cpu")
    assert plain.rescore_placement() is None

    events: list[dict] = []
    store = RingStore(
        ["a", "b", "c", "d"], replica_points=16, placement="dgro",
        placement_kw={"candidates": 2, "probes": 1 << 8},
        on_update=events.append, device="cpu",
    )
    g0 = store.gen
    rec = store.rescore_placement()
    assert rec is not None and rec["gen"] == g0 + 1
    assert rec["rescored"] is True
    # the fresh scorer report rides the record for the journal
    assert "placement" in rec and "movement_chosen" in rec["placement"]
    assert events[-1].get("rescored") is True


def test_rank_load_is_the_skew_signal():
    from ringpop_tpu_torch.forward.batch import rank_load
    from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens

    toks, _ = build_ring_tokens([f"s{i}" for i in range(4)], 8, device="cpu")
    tokens = np.asarray(toks, np.uint32)
    rng = np.random.default_rng(7)
    hashes = rng.integers(0, 1 << 32, size=512, dtype=np.uint64).astype(
        np.uint32
    )
    loads = rank_load(tokens, hashes, 2)
    assert loads.shape == (2,) and loads.dtype == np.int64
    assert int(loads.sum()) == 512
    assert (loads > 0).all()  # 512 uniform keys never land one-sided


# -- the same inputs through both packages -------------------------------------


def _no_clock(records):
    return [{k: v for k, v in r.items() if k != "t"} for r in records]


def _alert_history(rules_mod, ctl_mod, store):
    """One seeded history of snapshots through a rule engine of every rule
    kind and a controller with every action; returns the journal."""
    journal = []
    eng = rules_mod.RuleEngine(
        [
            rules_mod.Threshold(id="hot", key="g", op=">", firing=10.0, clear=5.0, hold=2, hold_clear=2),
            rules_mod.RateOfChange(id="spike", key="c", source="counters", spike_ratio=4.0, floor=1.0,
                                   per_rank=False, hold=1),
            rules_mod.CrossRankSkew(id="skew", key="share", source="gauges", ratio=1.5, hold=2),
            rules_mod.Staleness(id="stale", hold=2),
        ],
        sink=journal.append,
    )
    ctl = ctl_mod.OpsController(
        sink=journal.append,
        policy={"spike": "drain", "skew": "dgro_rescore", "stale": "resize"},
        ring_store=store, server_of=lambda rank: "z0",
        resize=lambda rank: {"rank": rank, "resumed": True},
        drain_probe=lambda server: 0, cooldown=2,
    )
    rng = np.random.default_rng(11)
    counter = 0.0
    for tick in range(24):
        counter += 10.0 if tick not in (9, 10, 17) else 300.0
        snaps = {
            r: {"gauges": {"g": float(rng.integers(0, 16)), "share": float(1 + (r == 1) * (tick > 12) * 2)},
                "counters": {"c": counter * (r + 1)}}
            for r in range(3)
        }
        ages = {str(r): {"age_s": 100.0 if (r == 2 and 14 < tick < 20) else 1.0,
                         "live": not (r == 2 and 14 < tick < 20)} for r in range(3)}
        alerts = eng.evaluate(snaps, health={"rank": 0, "ranks": ages}, tick=tick)
        ctl.on_alerts(alerts, tick=tick)
    return journal


def test_rules_and_controller_records_equal_jax():
    from ringpop_tpu.obs import controller as jctl
    from ringpop_tpu.obs import rules as jrules
    from ringpop_tpu.serve.state import RingStore as JaxRingStore
    from ringpop_tpu_torch.obs import controller as tctl
    from ringpop_tpu_torch.obs import rules as trules
    from ringpop_tpu_torch.serve.state import RingStore

    kw = dict(replica_points=16, placement="dgro", placement_kw={"candidates": 2, "probes": 1000})
    zones = ["z0", "z1", "z2", "z3"]
    got = _alert_history(trules, tctl, RingStore(zones, device="cpu", **kw))
    want = _alert_history(jrules, jctl, JaxRingStore(zones, **kw))
    kinds = {(r["kind"], r.get("rule"), r.get("action")) for r in got}
    assert {("alert", rule, None) for rule in ("hot", "spike", "skew", "stale")} <= kinds
    assert {("action", rule, act) for rule, act in (("spike", "drain"), ("skew", "dgro_rescore"),
                                                   ("stale", "resize"))} <= kinds
    assert _no_clock(got) == _no_clock(want)


def test_aggregate_and_prometheus_equal_jax():
    from ringpop_tpu.obs import aggregate as jagg

    snaps = []
    for mod in (agg, jagg):
        st = mod.AggregatingStats()
        for i in range(50):
            st.incr(f"ringpop.sim.k{i % 3}", i)
            st.gauge("ringpop.serve.keys.share", i / 7)
            st.timing("ringpop.obs.t", (i % 11) / 13)
        snaps.append(st.snapshot())
    for snap in snaps:
        snap.pop("rates_1m")  # an EWMA of the wall clock
    assert snaps[0] == snaps[1]
    assert agg.render_prometheus({0: snaps[0], 1: snaps[0]}) == jagg.render_prometheus({0: snaps[1], 1: snaps[1]})
    assert agg.merge_counter_totals({0: snaps[0]}) == jagg.merge_counter_totals({0: snaps[1]})


def test_metrics_carry_the_sim_counters_after_a_block():
    """A fleet block through ``LiveOps.block_record`` lands the sim plane's
    counters on ``/metrics`` (a wrong import there would be swallowed by
    the ops plane's own error guard and drop them all)."""
    from ringpop_tpu_torch.sim import chaos, scenarios, topology
    from ringpop_tpu_torch.sim.lifecycle import LifecycleParams
    from ringpop_tpu_torch.sim.telemetry import STAT_KEYS

    ops = LiveOps(0, 1)
    topo = topology.default_topology(32)
    plan = chaos.stack_plans([topology.zone_loss_plan(topo, 0, at=4, device="cpu")])
    sweep = scenarios.FleetSweep(
        LifecycleParams(n=32, k=32, suspect_ticks=10, rng="counter"), plan,
        [{"scenario_id": 0, "event": "zone_cut", "rep": 0}], [0], horizon=16, journal_every=8,
        scenario="gameday", obs=ops, device="cpu",
    )
    sweep.run()
    addr = ops.serve()
    try:
        text = _scrape(addr, "/metrics")
    finally:
        ops.close()
    counters = ops.stats.snapshot()["counters"]
    blocks = sweep.blocks[0]
    summed = [(field, suffix) for field, (kind, suffix) in STAT_KEYS.items() if kind == "incr" and field in blocks[0]]
    assert len(blocks) == 2 and len(summed) >= 8
    for field, suffix in summed:
        assert counters[f"ringpop.sim.{suffix}"] == sum(int(b[field]) for b in blocks), field
    assert counters["ringpop.sim.ping.timeout"] > 0
    assert 'ringpop_sim_ping_timeout{rank="0"}' in text
    assert 'ringpop_obs_progress_ticks_done{rank="0"} 16' in text


def test_gameday_zone_cut_equals_jax():
    """``gameday_pair("zone_cut", n=64, horizon=48)`` on the CPU: the
    controller-on and -off digests, ``ttm_on`` < ``ttm_off``, the drain and
    its effect, the reconstructed chain, and every alert and action record
    (bar the wall clock) equal the JAX package's run."""
    from ringpop_tpu.obs.gameday import gameday_pair as jax_gameday_pair
    from ringpop_tpu_torch.obs.gameday import gameday_pair

    got = gameday_pair(scenario="zone_cut", n=64, horizon=48, device="cpu")
    want = jax_gameday_pair(scenario="zone_cut", n=64, horizon=48)
    for key in ("digest_equal", "ttm_on", "ttm_off", "mitigated_earlier"):
        assert got[key] == want[key], key
    assert got["mitigated_earlier"] and got["digest_equal"] and (got["ttm_on"], got["ttm_off"]) == (8, 24)
    for side in ("on", "off"):
        g, w = got[side], want[side]
        assert g["digests"] == w["digests"]
        for key in ("cut_at", "mitigation_tick", "organic_tick", "ttm", "ring_gen", "flight_dumps"):
            assert g[key] == w[key], (side, key)
        assert _no_clock(g["alerts"]) == _no_clock(w["alerts"])
        assert _no_clock(g["actions"]) == _no_clock(w["actions"])
        assert [_no_clock(c) for c in g["chains"]] == [_no_clock(c) for c in w["chains"]]
    assert {a["rule"] for a in got["on"]["alerts"]} == {"probe-timeout-spike"}
    assert got["off"]["actions"] == [] and got["on"]["ring_gen"] == 1
