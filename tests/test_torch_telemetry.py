"""The telemetry plane: PyTorch port against the JAX package.

On the CPU, bit for bit: ``leaf_digest_sum`` and ``tree_digest`` (kernel
D1's plain version) on every leaf dtype and shape class of both engines'
states (0-d, [K], [N], [N, W] and [N, K]; bool, int8 with negatives, int32
planes holding uint32 bits, the int64 key holding uint32) at zero and
nonzero offsets, on both engines' states after a few ticks, and a single
bit flip moving the digest; ``accumulate`` (P1's plain version and the
plain legs) and ``fetch`` on random inputs, the per-tier and directed legs
included; the lifecycle engine with telemetry at both streams and both
exchanges: the telemetry-on state bit-equal to the telemetry-off one,
every block record equal to the JAX package's, and the block-accumulated
record equal to one built tick by tick; ``DeltaSim(telemetry_sink=...)``'s
records; the host half (journal header/block/score round trip under
OBSERVABILITY.md's schema index, ``emit_stats`` keys, ``TelemetrySink``'s
fan-out, ``split_batched``).

Records' float32 fields are the N·T-scaling sums, which the JAX package
takes in float32 in XLA:CPU's order; the port's ``f32_sum_plain`` (kernel
R1's plain version) takes them in that order, so they are equal bit for bit
at every size: held here against live ``jnp.sum(dtype=float32)`` over a
grid of shapes whose every sum passes 2**24, and the whole ``fetch`` against
the JAX package's, eager and jitted, at N = 100003 and 2**20 with every
float32 key past 2**24.  The one reduce whose order is not pinned (a full
sum over [N <= 32, W >= 2]) is taken exactly, which equals any order below
2**24.  ``chip_smoke.records_match`` allows no tolerance.
"""

import functools
import json
import re
import zlib
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.options import InMemoryStats as JStats
from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim import telemetry as jt
from ringpop_tpu_torch.events import EventEmitter, SimTickBlockEvent
from ringpop_tpu_torch.options import InMemoryStats
from ringpop_tpu_torch.sim import delta as td
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.sim import telemetry as tt

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the digest (D1's plain version) ------------------------------------------

# (JAX numpy dtype, port torch dtype, how the port holds it)
DTYPES = {
    "bool": (np.bool_, torch.bool),
    "int8": (np.int8, torch.int8),
    "int32": (np.int32, torch.int32),
    "uint32_plane": (np.uint32, torch.int32),  # the port's planes: int32 holding uint32 bits
    "uint32_key": (np.uint32, torch.int64),  # the port's key: int64 holding uint32
}
SHAPES = {"0d": (), "k": (40,), "n": (33,), "nw": (33, 2), "nk": (31, 40), "nk_wide": (5, 257)}


def _values(rng, dtype, shape):
    if dtype is np.bool_:
        return rng.random(shape) < 0.5
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, size=shape, dtype=np.int64).astype(dtype)


def _port_leaf(arr, np_dtype, dtype):
    if dtype == torch.int32 and np_dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32).copy())
    return torch.from_numpy(np.asarray(arr).astype({torch.int64: np.int64}.get(dtype, arr.dtype)).copy())


@pytest.mark.parametrize("offset", [0, 2**32 - 3])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_leaf_digest_sum_matches_jax(kind, shape, offset):
    np_dtype, dtype = DTYPES[kind]
    rng = np.random.default_rng(zlib.crc32(f"{kind}/{shape}".encode()))
    arr = _values(rng, np_dtype, SHAPES[shape])
    want = int(jt.leaf_digest_sum(jnp.asarray(arr), np.uint32(offset)))
    got = tt.leaf_digest_sum(_port_leaf(arr, np_dtype, dtype), offset)
    assert got.dtype == torch.int64 and got.shape == ()
    assert int(got) == want


def test_int8_negatives_sign_extend_as_jax_does():
    arr = np.array([-1, -128, 127, 0, 1], np.int8)
    assert np.asarray(jnp.asarray(arr).astype(jnp.uint32)).tolist() == [4294967295, 4294967168, 127, 0, 1]
    assert int(tt.leaf_digest_sum(torch.from_numpy(arr))) == int(jt.leaf_digest_sum(jnp.asarray(arr)))


def test_digest_chunks_agree_with_one_pass(monkeypatch):
    """The plain digest takes big leaves in chunks: the chunk size changes
    nothing, and a leaf's sum at a block's global offset is an exact
    partial of the whole leaf's."""
    rng = np.random.default_rng(3)
    arr = rng.integers(-128, 128, size=(97, 41), dtype=np.int64).astype(np.int8)
    leaf = torch.from_numpy(arr)
    whole = int(tt.leaf_digest_sum(leaf))
    monkeypatch.setattr(tt, "_DIGEST_CHUNK", 100)
    assert int(tt.leaf_digest_sum(leaf)) == whole
    parts = sum(int(tt.leaf_digest_sum(leaf[lo:lo + 10], offset=lo * 41)) for lo in range(0, 97, 10))
    assert parts % 2**32 == whole == int(jt.leaf_digest_sum(jnp.asarray(arr)))


@functools.lru_cache(maxsize=None)
def _lifecycle_pair(n=96, k=40, ticks=5):
    params = jl.LifecycleParams(n=n, k=k, rng="counter", heal_prob=0.5, suspect_ticks=3)
    up = np.ones(n, bool)
    up[[3, 50]] = False
    js = jl.init_state(params, seed=2)
    step = jax.jit(jl.step, static_argnums=0)
    faults = jd.DeltaFaults(up=jnp.asarray(up))
    for _ in range(ticks):
        js = step(params, js, faults)
    return js, tl.state_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")


def test_tree_digest_of_both_engines_states_matches_jax():
    js, ts = _lifecycle_pair()
    assert int(tt.tree_digest(ts)) == int(jt.tree_digest(js))
    # negatives in the int8 leaves, and slots in flight: not a vacuous state
    assert (ts.base_pending < 0).any() and (ts.r_subject >= 0).any()
    dparams = jd.DeltaParams(n=70, k=45, rng="counter")
    djs = jd.init_state(dparams, seed=4)
    for _ in range(3):
        djs = jax.jit(jd.step, static_argnums=0)(dparams, djs)
    dts = td.state_from_numpy(jax.tree_util.tree_map(np.asarray, djs), device="cpu")
    assert int(tt.tree_digest(dts)) == int(jt.tree_digest(djs))
    rec_j = jt._to_host(jt.delta_record(djs))
    rec_t = tt._to_host(tt.delta_record(dts))
    assert rec_t == rec_j


@pytest.mark.parametrize("leaf", ["pcount", "learned", "key", "tick", "base_present", "r_status"])
def test_a_single_bit_flip_changes_the_digest(leaf):
    _, ts = _lifecycle_pair(ticks=2)
    before = int(tt.tree_digest(ts))
    x = getattr(ts, leaf).clone()
    flat = x.view(-1)
    if x.dtype == torch.bool:
        flat[-1] = ~flat[-1]
    else:
        flat[-1] = flat[-1] ^ 1
    after = int(tt.tree_digest(ts._replace(**{leaf: x})))
    assert after != before
    js = jl.LifecycleState(*(jnp.asarray(v) for v in tl.state_to_numpy(ts._replace(**{leaf: x}))))
    assert after == int(jt.tree_digest(js))


def test_tree_digest_skips_none_and_keeps_field_order():
    tel = tt.zeros(tl.LifecycleParams(n=8, k=40), device="cpu")
    tel.pings[3] = 5
    jtel = jt.zeros(jl.LifecycleParams(n=8, k=40))._replace(pings=jnp.asarray(tel.pings.numpy()))
    assert int(tt.tree_digest(tel)) == int(jt.tree_digest(jtel))
    swapped = tel._replace(pings=tel.ping_reqs, ping_reqs=tel.pings)
    assert int(tt.tree_digest(swapped)) != int(tt.tree_digest(tel))


# -- accumulate and fetch ------------------------------------------------------


def _random_tick(rng, n, k, m, p=3, tiers=False):
    w = (k + 31) // 32
    b = lambda *s: rng.random(s) < 0.4  # noqa: E731
    words = lambda: rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(np.uint32)  # noqa: E731
    tick = dict(delivered=b(n), probing=b(n), peer_ok=b(n, p), refute=b(n), placed=b(n), sent_w=words(),
                resp_w=words(), ride_ok=words(), mid_ride_w=words(), fired=b(k), base_fired=b(n), place=b(m),
                new_status=rng.integers(0, 4, size=m).astype(np.int8), heal_attempt=np.bool_(rng.random() < 0.5))
    if tiers:
        tick.update(declared=b(n), declared_tier=rng.integers(0, 4, size=n).astype(np.int32), declared_up=b(n))
    return tick


def _jax_tick(t):
    j = {k: jnp.asarray(v) for k, v in t.items() if k not in ("peer_ok", "refute", "placed", "ride_ok",
                                                              "mid_ride_w")}
    j["ping_req_legs"] = jnp.asarray(np.where(t["probing"], t["peer_ok"].sum(1), 0).astype(np.int32))
    j["refuted"] = jnp.asarray(t["refute"] & t["placed"])
    j["closed_w"] = jnp.asarray(t["ride_ok"] & ~t["mid_ride_w"])
    return j


def _port_tick(t):
    out = {}
    for k, v in t.items():
        v = np.asarray(v)
        out[k] = torch.from_numpy(v.view(np.int32).copy() if v.dtype == np.uint32 else v.copy())
    return out


def _tel_numpy(tel):
    """The port's accumulators as numpy arrays of the JAX package's dtypes."""
    return {name: None if leaf is None else (leaf.numpy().view(np.uint32) if name in ("piggybacked", "expired")
                                             else leaf.numpy())
            for name, leaf in zip(tel._fields, tel)}


def _assert_same_tel(jtel, ttel):
    want = _tel_numpy(ttel)
    for name, leaf in zip(jtel._fields, jtel):
        if leaf is None:
            assert want[name] is None, name
            continue
        assert np.array_equal(np.asarray(leaf), want[name]), name
        assert np.asarray(leaf).dtype == want[name].dtype, name


@pytest.mark.parametrize("tiers", [False, True])
@pytest.mark.parametrize("n,k", [(1, 1), (33, 40), (200, 256)])
def test_accumulate_matches_jax(n, k, tiers):
    params = jl.LifecycleParams(n=n, k=k)
    m = jt.placement_budget(params)
    rng = np.random.default_rng(n * 1000 + k + tiers)
    jtel = jt.zeros(params, tiers=tiers)
    ttel = tt.zeros(tl.LifecycleParams(n=n, k=k), tiers=tiers, device="cpu")
    for _ in range(3):
        tick = _random_tick(rng, n, k, m, tiers=tiers)
        jtel = jt.accumulate(jtel, **_jax_tick(tick))
        ttel = tt.accumulate(ttel, **_port_tick(tick))
    _assert_same_tel(jtel, ttel)
    # the carried-across accumulator: the JAX one loaded into the port
    back = tt.telemetry_from_numpy(jax.tree_util.tree_map(np.asarray, jtel), device="cpu")
    _assert_same_tel(jtel, back)
    assert (tiers and back.suspects_by_tier is not None) or (not tiers and back.suspects_by_tier is None)


def test_accumulate_updates_in_place_and_heal_none_leaves_heals():
    params = tl.LifecycleParams(n=10, k=40)
    rng = np.random.default_rng(0)
    tel = tt.zeros(params, device="cpu")
    pings = tel.pings
    tick = _port_tick(_random_tick(rng, 10, 40, tt.placement_budget(params)))
    tick["heal_attempt"] = None
    out = tt.accumulate(tel, **tick)
    assert out.pings is pings and int(out.ticks) == 1 and int(out.heal_attempts) == 0
    assert torch.equal(pings, tick["delivered"].to(torch.int32))


@pytest.mark.parametrize("faults_kind", ["none", "up", "asym", "symmetric"])
def test_fetch_matches_jax(faults_kind):
    js, ts = _lifecycle_pair(ticks=4)
    n, k = ts.learned.shape[0], ts.r_subject.shape[0]
    params = jl.LifecycleParams(n=n, k=k)
    rng = np.random.default_rng(9)
    jtel, ttel = jt.zeros(params, tiers=True), tt.zeros(tl.LifecycleParams(n=n, k=k), tiers=True, device="cpu")
    for _ in range(2):
        tick = _random_tick(rng, n, k, jt.placement_budget(params), tiers=True)
        jtel = jt.accumulate(jtel, **_jax_tick(tick))
        ttel = tt.accumulate(ttel, **_port_tick(tick))
    up = np.ones(n, bool)
    up[[3, 50, 60]] = False
    group = np.where(np.arange(n) < 30, 1, np.where(np.arange(n) < 40, -1, 0)).astype(np.int32)
    legs = {"none": {}, "up": {"up": up}, "asym": {"up": up, "group": group,
                                                   "reach": np.array([[True, False], [True, True]])},
            "symmetric": {"group": group, "reach": np.eye(2, dtype=bool)}}[faults_kind]
    jf = jd.DeltaFaults(**{k: jnp.asarray(v) for k, v in legs.items()})
    tf = td.DeltaFaults(**{k: torch.from_numpy(np.asarray(v)) for k, v in legs.items()})
    jrec, jfresh = jt.fetch(jtel, js, jf)
    trec, tfresh = tt.fetch(ttel, ts, tf)
    assert tt._to_host(trec) == jt._to_host(jrec)
    assert set(trec) == set(jrec)
    _assert_same_tel(jfresh, tfresh)
    if faults_kind == "asym":
        assert tt._to_host(trec)["refuted_unreachable_dir"] > 0


# -- the lifecycle engine with telemetry ---------------------------------------


def _faults(n):
    up = np.ones(n, bool)
    up[[5, 77, 130]] = False
    return jd.DeltaFaults(up=jnp.asarray(up), drop_rate=jnp.float32(0.05)), td.DeltaFaults(
        up=torch.from_numpy(up), drop_rate=0.05)


@pytest.mark.parametrize("rng_kind,exchange", [("counter", "uniform"), ("threefry", "shift")])
def test_lifecycle_telemetry_records_match_jax_and_leave_the_state_alone(rng_kind, exchange):
    n, k, seed = 160, 64, 3
    kw = dict(k=k, seed=seed, rng=rng_kind, exchange=exchange, suspect_ticks=4, heal_prob=0.3)
    jf, tf = _faults(n)
    jsink, tsink = jt.TelemetrySink(), tt.TelemetrySink()
    jsim = jl.LifecycleSim(n=n, telemetry=jsink, journal_views=True, **kw)
    tsim = tl.LifecycleSim(n=n, telemetry=tsink, journal_views=True, device="cpu", **kw)
    off = tl.LifecycleSim(n=n, device="cpu", **kw)
    for sim, f in ((jsim, jf), (tsim, tf), (off, tf)):
        sim.run(6, f)
        sim.run_until_detected([5, 77, 130], f, max_ticks=48, check_every=8, blocks_per_dispatch=2)
        sim.run_until_converged(f, max_ticks=16, check_every=8, blocks_per_dispatch=2)
    assert len(tsink.records) == len(jsink.records) >= 3
    assert tsink.records == jsink.records
    for a, b in zip(off.state, tsim.state):
        assert torch.equal(a, b)
    assert tsink.records[-1]["state_digest"] == int(tt.tree_digest(off.state))
    assert sum(r["ticks"] for r in tsink.records) == int(tsim.state.tick)
    assert sum(r["decl_suspect"] for r in tsink.records) > 0 and sum(r["ping_timeout"] for r in tsink.records) > 0


def test_block_record_equals_the_tick_by_tick_record():
    n, k = 160, 40
    jf, tf = _faults(n)
    kw = dict(n=n, k=k, seed=1, rng="counter", suspect_ticks=3, device="cpu")
    block = tl.LifecycleSim(telemetry=True, **kw)
    block.run(12, tf)
    by_tick = tl.LifecycleSim(telemetry=True, **kw)
    for _ in range(12):
        by_tick.tick(tf)
    assert block.fetch_telemetry(tf) == by_tick.fetch_telemetry(tf)
    # a fetch resets: the next record counts from zero
    assert block.fetch_telemetry(tf)["ticks"] == 0
    jsim = jl.LifecycleSim(n=n, k=k, seed=1, rng="counter", suspect_ticks=3, telemetry=True)
    jsim.run(12, jf)
    tsim2 = tl.LifecycleSim(telemetry=True, **kw)
    tsim2.run(12, tf)
    assert tsim2.fetch_telemetry(tf) == jsim.fetch_telemetry(jf)


def test_telemetry_off_launches_nothing_new():
    """The None leg: a telemetry-off sim carries no accumulator and its
    step returns a bare state."""
    sim = tl.LifecycleSim(n=32, k=40, seed=0, rng="counter", device="cpu")
    assert sim.telemetry is None and sim.fetch_telemetry() is None
    out = tl.step(sim.params, sim.state)
    assert isinstance(out, tl.LifecycleState)
    out2 = tl.step(sim.params, sim.state, telemetry=tt.zeros(sim.params, device="cpu"))
    assert isinstance(out2, tuple) and len(out2) == 2 and isinstance(out2[1], tt.TelemetryState)
    for a, b in zip(out, out2[0]):
        assert torch.equal(a, b)


# -- the delta engine's journal ---------------------------------------------------


def test_delta_journal_matches_jax():
    n, k = 300, 40
    group = np.zeros(n, np.int32)
    group[: int(0.3 * n)] = 1
    jr, tr = [], []
    jsim = jd.DeltaSim(n=n, k=k, seed=0, rng="counter", telemetry_sink=lambda r: jr.append(jt._to_host(r)))
    tsim = td.DeltaSim(n=n, k=k, seed=0, rng="counter", device="cpu", telemetry_sink=tr.append)
    for sim, mk, recs in ((jsim, jnp.asarray, jr), (tsim, torch.from_numpy, tr)):
        faults = (jd if sim is jsim else td).DeltaFaults(up=mk(np.ones(n, bool)), group=mk(group))
        assert sim.run_until_converged(faults, max_ticks=40, journal_every=16) == (40, False)
        heal = (jd if sim is jsim else td).DeltaFaults(up=mk(np.ones(n, bool)))
        out = sim.run_until_converged(heal, max_ticks=200, journal_every=16)
        assert out[1]
    assert [tt._to_host(r) for r in tr] == jr
    assert len(jr) == 3 + (out[0] + 15) // 16
    assert jr[-1]["coverage"] == 1.0


# -- the host half -------------------------------------------------------------------


def _schema() -> dict:
    """OBSERVABILITY.md's journal record schema index: kind -> literal keys."""
    text = (REPO / "OBSERVABILITY.md").read_text()
    table = text[text.index("## Journal record schema index"):]
    rows = {}
    for line in table.splitlines():
        m = re.match(r"\| `(\w+)` \| (.*?) \| (.*?) \|$", line)
        if m:
            rows[m.group(1)] = set(re.findall(r"`(\w+)`", m.group(2)))
    return rows


def test_journal_round_trips_under_the_schema(tmp_path):
    from ringpop_tpu_torch.sim import chaos as tc

    schema = _schema()
    path = tmp_path / "run.jsonl"
    with tt.TelemetryJournal(str(path)) as journal:
        journal.header("lifecycle", "unit", {"n": 64})
        sink = tt.TelemetrySink(journal=journal)
        plan = tc.scenario_plan("smoke", 64, horizon=32, device="cpu")
        sim = tl.LifecycleSim(n=64, k=40, seed=0, rng="counter", suspect_ticks=4, telemetry=sink, device="cpu")
        for _ in range(4):
            sim.run(8, plan)
        score = tc.score_blocks(sink.records, plan, n=64, scenario="unit")
        journal.score(score)
    records = tt.read_journal(str(path))
    assert [r["kind"] for r in records] == ["header"] + ["block"] * 4 + ["score"]
    header = records[0]
    assert set(header) - {"kind"} == schema["header"]
    assert {"torch", "cuda", "numpy", "python"} == set(header["toolchain"])
    assert header["compile_cache"]["persistent"] is False and header["compile_cache"]["cache_dir"] is None
    assert header["process_count"] == 1 and header["process_id"] == 0
    assert header["git_commit"] is None or re.fullmatch(r"[0-9a-f]{40}", header["git_commit"])
    assert records[1:5] == [{"kind": "block", **r} for r in sink.records]
    assert schema["block"] & set(records[1]) == {"tick", "ticks", "detect_frac"}
    assert schema["score"] <= set(records[-1])
    assert json.loads(json.dumps(score)) == {k: v for k, v in records[-1].items()}
    for r in records:
        assert r["kind"] in schema


def test_emit_stats_feeds_the_jax_packages_keys():
    rng = np.random.default_rng(5)
    record = {key: float(rng.integers(0, 100)) for key in jt.STAT_KEYS}
    jstats, tstats = JStats(), InMemoryStats()
    jt.emit_stats(jstats, record)
    tt.emit_stats(tstats, record)
    assert tstats.counters == jstats.counters and tstats.gauges == jstats.gauges
    assert tt.STAT_KEYS == jt.STAT_KEYS and tt.TIER_KEYS == jt.TIER_KEYS
    assert set(tstats.counters) | set(tstats.gauges) == {f"ringpop.sim.{s}" for _, s in jt.STAT_KEYS.values()}


def test_sink_fans_out_to_journal_stats_emitter_and_callable(tmp_path):
    path = tmp_path / "fan.jsonl"
    events, seen = [], []

    class Listener:
        def handle_event(self, event):
            events.append(event)

    emitter = EventEmitter()
    emitter.register_listener(Listener())
    stats = InMemoryStats()
    with tt.TelemetryJournal(str(path)) as journal:
        sink = tt.TelemetrySink(journal=journal, stats=stats, emitter=emitter, fn=seen.append)
        sink({"tick": torch.tensor(8, dtype=torch.int32), "ping_send": torch.tensor(3.25, dtype=torch.float32),
              "detect_frac": torch.tensor(1 / 3, dtype=torch.float32)}, state_digest=torch.tensor(2**32 - 1))
    want = {"tick": 8, "ping_send": 3.25, "detect_frac": 0.333333, "state_digest": 2**32 - 1}
    assert sink.records == [want] and seen == [want]
    assert len(events) == 1 and isinstance(events[0], SimTickBlockEvent) and events[0].record == want
    assert stats.counters == {"ringpop.sim.ping.send": 3} and stats.gauges == {"ringpop.sim.detection.fraction":
                                                                               0.333333}
    assert tt.read_journal(str(path)) == [{"kind": "block", **want}]


def test_split_batched_matches_jax():
    record = {"tick": np.array([4, 4, 4], np.int32), "detect_frac": np.array([0.5, 1.0, 0.25], np.float32),
              "ticks": np.int32(4)}
    extra = {"state_digest": np.array([1, 2, 2**32 - 1], np.uint32)}
    want = jt.split_batched({k: jnp.asarray(v) for k, v in record.items()}, {"state_digest":
                                                                               jnp.asarray(extra["state_digest"])},
                            id_base=10)
    got = tt.split_batched({k: torch.from_numpy(np.asarray(v).astype(np.int64 if v.dtype == np.uint32 else v.dtype))
                            for k, v in record.items()},
                           {"state_digest": torch.from_numpy(extra["state_digest"].astype(np.int64))}, id_base=10)
    assert got == want and [r["scenario_id"] for r in got] == [10, 11, 12]


def test_records_match_allows_the_float_tolerance_only_above_2_24():
    """No tolerance is left, above 2**24 or below: ``records_match`` demands
    every key equal, of the same type, at every size."""
    big = float(2**26)
    assert chip_smoke.records_match([{"ping_send": big, "tick": 3}], [{"ping_send": big, "tick": 3}])
    assert not chip_smoke.records_match([{"ping_send": big + 32, "tick": 3}], [{"ping_send": big, "tick": 3}])
    assert not chip_smoke.records_match([{"rumors_piggybacked": 157241616.0}], [{"rumors_piggybacked": 157241632.0}])
    assert not chip_smoke.records_match([{"ping_send": 1000.0, "tick": 3}], [{"ping_send": 1001.0, "tick": 3}])
    assert not chip_smoke.records_match([{"ping_send": big, "tick": 4}], [{"ping_send": big, "tick": 3}])
    assert not chip_smoke.records_match([{"detect_frac": 0.5}], [{"detect_frac": 0.5000001}])
    assert not chip_smoke.records_match([{"tick": 3.0}], [{"tick": 3}])
    assert not chip_smoke.records_match([{"tick": 3}], [{"tick": 3}, {"tick": 4}])
    assert not hasattr(chip_smoke, "TEL_SUM_RTOL") and not hasattr(chip_smoke, "TEL_SUM_EXACT_BELOW")


# -- the float32 sums in XLA:CPU's order (kernel R1's plain version) -----------

SUM_ROWS = (1, 31, 32, 33, 63, 1000, 1023, 4097, 100003, 2**20)
SUM_CASES = ([("vector", n, 1) for n in SUM_ROWS] + [("plane", n, w) for n in SUM_ROWS if n >= 33 for w in (1, 2, 8)]
             + [("uplane", n, w) for n in (63, 1023, 100003, 2**20) for w in (2, 4, 8)]
             + [("columns", n, 4) for n in SUM_ROWS])


@functools.lru_cache(maxsize=None)
def _jax_sum(axis):
    return jax.jit(lambda a: a.sum(axis=axis, dtype=jnp.float32))


@pytest.mark.parametrize("what,n,w", SUM_CASES)
def test_f32_sum_matches_jax_bit_for_bit_above_2_24(what, n, w):
    """The JAX package's ``x.sum(dtype=float32)`` (``axis=0`` for the
    columns), live, against ``f32_sum_plain``: every sum past 2**24, so the
    order of the adds decides the last bits: the windows, their padding,
    the lanes of an unpadded level and of one padded by a row."""
    rng = np.random.default_rng(n * 16 + w)
    shape = (n,) if what == "vector" else (n, w)
    if what == "uplane":
        x = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
        port = torch.from_numpy(x.view(np.int32))
    else:
        x = rng.integers(2**24, 2**28, size=shape).astype(np.int32)
        port = torch.from_numpy(x)
    by_column = what == "columns"
    want = np.asarray(_jax_sum(0 if by_column else None)(jnp.asarray(x)))
    got = tt.f32_sum_plain(port, unsigned=what == "uplane", by_column=by_column).numpy()
    assert (np.abs(want) > 2**24).all()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes(), (got, want)


def test_f32_sum_of_the_unpinned_reduce_is_exact_and_equal_below_2_24():
    """A full sum over [N <= 32, W >= 2] is the one reduce whose order is not
    pinned (LLVM's vectorizer picks its lanes by N and W): the port takes it
    exactly and rounds once, which equals the JAX package's wherever the
    sum stays below 2**24, at shapes across that range."""
    rng = np.random.default_rng(24)
    f = _jax_sum(None)
    for n in (1, 2, 3, 5, 8, 13, 20, 21, 31, 32):
        for w in (2, 3, 8):
            x = rng.integers(0, 2**24 // (n * w), size=(n, w)).astype(np.int32)
            got = tt.f32_sum_plain(torch.from_numpy(x))
            assert float(got) == float(x.astype(np.int64).sum()) < 2**24
            assert got.numpy().tobytes() == np.asarray(f(jnp.asarray(x))).tobytes(), (n, w)
            assert tt.sum_lanes(n, w) == 0


class _Census(NamedTuple):
    """The state leaves ``fetch`` reads, in both packages."""
    tick: object
    base_present: object
    base_status: object
    r_subject: object


@pytest.mark.parametrize("n", [100003, 2**17])
def test_fetch_matches_jax_with_every_float_key_above_2_24(n):
    """A synthetic accumulator at N = 100003 (its first-level windows padded
    in front: in order) and 2**17 (unpadded: the planes' windows in lanes),
    K = 256, tiers and the directed legs armed, every float32 key of the
    record past 2**24: the port's ``fetch`` == the JAX package's, eager and
    under ``jax.jit`` (as ``LifecycleSim`` takes it), carried across with
    ``telemetry_from_numpy``."""
    k = 256
    rng = np.random.default_rng(n)
    zero = jt.zeros(jl.LifecycleParams(n=n, k=k), tiers=True)
    leaves = {name: np.asarray(x) for name, x in zip(zero._fields, zero)}
    for name in ("pings", "ping_reqs", "probes_failed", "incarnation_bumps", "base_timer_fires", "suspects_by_tier",
                 "false_suspects_by_tier"):
        leaves[name] = rng.integers(2**9, 2**12, size=leaves[name].shape).astype(np.int32)
    for name in ("piggybacked", "expired"):
        leaves[name] = rng.integers(0, 2**28, size=leaves[name].shape).astype(np.uint32)
    leaves["timer_fires"] = rng.integers(2**17, 2**20, size=k).astype(np.int32)
    jtel = type(zero)(**{name: jnp.asarray(leaves[name]) for name in zero._fields})
    ttel = tt.telemetry_from_numpy([leaves[name] for name in zero._fields], device="cpu")
    present, status = rng.random(n) < 0.9, rng.integers(0, 4, size=n).astype(np.int8)
    subject = rng.integers(-1, n, size=k).astype(np.int32)
    up, group = rng.random(n) < 0.7, rng.integers(-1, 3, size=n).astype(np.int32)
    reach = np.array([[True, False, True], [True, True, True], [False, True, True]])
    js = _Census(jnp.int32(77), *(jnp.asarray(a) for a in (present, status, subject)))
    ts = _Census(torch.tensor(77, dtype=torch.int32), *(torch.from_numpy(a) for a in (present, status, subject)))
    jf = jd.DeltaFaults(up=jnp.asarray(up), group=jnp.asarray(group), reach=jnp.asarray(reach))
    tf = td.DeltaFaults(up=torch.from_numpy(up), group=torch.from_numpy(group), reach=torch.from_numpy(reach))
    got = tt._to_host(tt.fetch(ttel, ts, tf)[0])
    floats = {key: v for key, v in got.items() if isinstance(v, float) and key != "detect_frac"}
    assert len(floats) == 17 and all(v > 2**24 for v in floats.values()), floats
    for fetch in (jt.fetch, jax.jit(jt.fetch)):
        want = jt._to_host(fetch(jtel, js, jf)[0])
        assert got == want and all(type(got[key]) is type(want[key]) for key in want)
