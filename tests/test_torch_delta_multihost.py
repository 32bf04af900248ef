"""The port's process-spanning delta engine (``ringpop_tpu_torch/sim/
delta_multihost.py``) against the JAX package's, bit for bit, on the CPU.

Ranks are threads of this process, one ``Fabric`` each over a ``LocalKV``
(the fabric code paths are those of OS processes; tests/
test_torch_multihost_procs.py runs real ones).  The same seeds, victims and
loss go through the JAX engine (``delta.step``), the JAX ``MultihostDelta``
and the port's at ``DeltaParams(n=128, k=64, rng="counter")``, mirroring
tests/test_multihost.py: the digests, coverage, ``d2h_bytes``, the fabric's
wire and raw bytes and codec counts, and the journal records minus their
timing keys are equal at P = 1, 2 and 4, codec on and off; swing and
overlap keep the digest; ``run_until_converged`` stops at the same tick;
unsupported faults are refused; a JAX state's block installed across
process counts resets the codec epoch and continues equal.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.parallel import fabric as jf
from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim import delta_multihost as jmh
from ringpop_tpu.sim.telemetry import tree_digest
from ringpop_tpu_torch.parallel import fabric as tf
from ringpop_tpu_torch.parallel.partition import process_block
from ringpop_tpu_torch.sim import delta as td
from ringpop_tpu_torch.sim import delta_multihost as tmh

N, K = 128, 64
TIMING_KEYS = ("fabric_leg_ms", "overlap_hidden_ms")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_faults(n=N, every=9, drop=0.1):
    up = np.ones(n, bool)
    up[::every] = False
    return jd.DeltaFaults(up=jnp.asarray(up), drop_rate=jnp.float32(drop))


def engine_digest(params, faults, seed, ticks):
    st = jd.init_state(params, seed=seed)
    stp = jax.jit(functools.partial(jd.step, params))
    for _ in range(ticks):
        st = stp(st, faults)
    return int(tree_digest(st)), st


def run_ranks(port: bool, nprocs: int, body, ns: str, codec: bool = True):
    """``body(fabric, rank)`` on ``nprocs`` rank threads over the port's
    fabric (``port``) or the JAX package's; returns the results by rank."""
    mod = tf if port else jf
    kv = mod.LocalKV()
    out, errs = [None] * nprocs, []

    def run(rank):
        try:
            with mod.Fabric(rank, nprocs, kv, namespace=ns, codec=codec) as fab:
                out[rank] = body(fab, rank)
        except BaseException as e:  # noqa: BLE001 - raised below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(nprocs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(180)
    if errs:
        raise errs[0]
    assert all(o is not None for o in out), "a rank hung"
    return out


def twin_body(port: bool, params, faults, seed, ticks, **kw):
    """A run of ``ticks`` through MultihostDelta, journalling a light and a
    full record midway and at the end."""
    cls = tmh.MultihostDelta if port else jmh.MultihostDelta
    extra = {"device": "cpu"} if port else {}

    def body(fab, rank):
        mh = cls(params, fab, seed=seed, faults=faults, **kw, **extra)
        recs = []
        for t in range(ticks):
            mh.step()
            if t == ticks // 2:
                recs.append(mh.journal_record(light=True))
        recs.append(mh.journal_record())
        return {"digest": mh.state_digest(), "coverage": mh.coverage(), "converged": mh.converged,
                "d2h": mh.d2h_bytes, "wire": fab.wire_stats(),
                "records": [{k: v for k, v in r.items() if k not in TIMING_KEYS} for r in recs],
                "timing": [set(r["fabric_leg_ms"]) for r in recs]}

    return body


@pytest.mark.parametrize("codec", [True, False], ids=["codec-on", "codec-off"])
@pytest.mark.parametrize("nprocs", [1, 2, 4])
def test_twin_equals_the_jax_engine_and_multihost_delta(nprocs, codec):
    jparams = jd.DeltaParams(n=N, k=K, rng="counter")
    tparams = td.DeltaParams(n=N, k=K, rng="counter")
    jfaults = jax_faults()
    ref, _ = engine_digest(jparams, jfaults, seed=4, ticks=10)
    want = run_ranks(False, nprocs, twin_body(False, jparams, jfaults, 4, 10), f"j{nprocs}{codec}", codec)
    got = run_ranks(True, nprocs, twin_body(True, tparams, td.faults_from_numpy(jfaults, device="cpu"), 4, 10),
                    f"t{nprocs}{codec}", codec)
    assert {g["digest"] for g in got} == {ref}
    for rank in range(nprocs):
        g, w = got[rank], want[rank]
        assert g["coverage"] == w["coverage"] and g["converged"] == w["converged"]
        assert g["d2h"] == w["d2h"], (rank, g["d2h"], w["d2h"])
        assert g["wire"] == w["wire"], (rank, g["wire"], w["wire"])
        assert g["records"] == w["records"], rank
        assert g["timing"] == [{"leg1", "leg2", "reduce"}] * 2
    if nprocs == 1:
        assert got[0]["d2h"] == 0 and got[0]["wire"]["bytes_sent"] == 0
    elif codec:
        assert got[0]["wire"]["bytes_sent"] < got[0]["wire"]["raw_bytes_sent"]


@pytest.mark.parametrize("overlap", [False, True], ids=["sequential", "overlap"])
@pytest.mark.parametrize("schedule", ["cyclic", "swing"])
@pytest.mark.parametrize("nprocs", [2, 4])
def test_swing_and_overlap_keep_the_engine_digest(nprocs, schedule, overlap):
    n = 256
    jfaults = jax_faults(n, every=11, drop=0.07)
    ref, _ = engine_digest(jd.DeltaParams(n=n, k=K, rng="counter"), jfaults, seed=6, ticks=9)
    got = run_ranks(True, nprocs, twin_body(True, td.DeltaParams(n=n, k=K, rng="counter"),
                                            td.faults_from_numpy(jfaults, device="cpu"), 6, 9,
                                            schedule=schedule, overlap=overlap), f"so{nprocs}{schedule}{overlap}")
    assert {g["digest"] for g in got} == {ref}
    assert len({g["coverage"] for g in got}) == 1
    for g in got:
        assert all(r["schedule"] == schedule and r["overlap"] is overlap for r in g["records"])


def test_swing_relay_bytes_equal_the_jax_engine():
    """The swing relay's bytes are the JAX engine's: at P = 2 the schedule
    sends what cyclic sends; at P = 4 the relayed pieces cost more raw
    bytes than the direct sends."""
    tparams, jparams = td.DeltaParams(n=256, k=K, rng="counter"), jd.DeltaParams(n=256, k=K, rng="counter")
    by = {}
    for nprocs in (2, 4):
        for schedule in ("cyclic", "swing"):
            got = run_ranks(True, nprocs, twin_body(True, tparams, None, 5, 6, schedule=schedule),
                            f"rt{nprocs}{schedule}", codec=False)
            by[(nprocs, schedule)] = got[0]["wire"]["raw_bytes_sent"]
    want = run_ranks(False, 4, twin_body(False, jparams, None, 5, 6, schedule="swing"), "rj4", codec=False)
    assert by[(4, "swing")] == want[0]["wire"]["raw_bytes_sent"]
    assert by[(2, "swing")] == by[(2, "cyclic")]
    assert by[(4, "swing")] > by[(4, "cyclic")]


def test_run_until_converged_matches_the_engine():
    params = jd.DeltaParams(n=N, k=K, rng="counter")
    st = jd.init_state(params, seed=2)
    st, ticks, ok = jd.run_until_converged(params, st, jd.DeltaFaults(), max_ticks=512, check_every=1)
    assert ok
    ref = int(tree_digest(st))
    tparams = td.DeltaParams(n=N, k=K, rng="counter")

    def body(fab, rank):
        mh = tmh.MultihostDelta(tparams, fab, seed=2, device="cpu")
        recs = []
        t, c = mh.run_until_converged(max_ticks=512, sink=recs.append, journal_every=4, journal_light=True)
        return t, c, mh.state_digest(), [("digest" in r, r["tick"]) for r in recs]

    out = run_ranks(True, 2, body, "conv")
    assert out[0] == out[1]
    t, c, digest, recs = out[0]
    assert (t, c, digest) == (ticks, True, ref)
    # light periodic records, a full one at exit
    assert recs[-1] == (True, ticks) and all(not full for full, _ in recs[:-1])


def test_unsupported_faults_are_refused():
    params = td.DeltaParams(n=64, k=64, rng="counter")
    fab = tf.Fabric(0, 1, tf.LocalKV())
    for faults in (td.DeltaFaults(group=torch.zeros(64, dtype=torch.int32)),
                   td.DeltaFaults(drop_node=torch.zeros(64)),
                   td.DeltaFaults(suspect_ticks=torch.zeros((), dtype=torch.int32))):
        with pytest.raises(NotImplementedError):
            tmh.MultihostDelta(params, fab, faults=faults, device="cpu")

    class Plan:
        def at_tick(self, tick):
            return td.DeltaFaults()

    with pytest.raises(NotImplementedError):
        tmh.MultihostDelta(params, fab, faults=Plan(), device="cpu")
    with pytest.raises(NotImplementedError):  # threefry: the counter stream is what makes ranks agree
        tmh.MultihostDelta(td.DeltaParams(n=64, k=64), fab, device="cpu")
    with pytest.raises(NotImplementedError):
        tmh.MultihostDelta(td.DeltaParams(n=64, k=64, rng="counter", exchange="uniform"), fab, device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        tmh.MultihostDelta(params, fab, schedule="ring", device="cpu")


def test_swing_refuses_a_process_count_not_a_power_of_two():
    params = td.DeltaParams(n=96, k=64, rng="counter")

    def body(fab, rank):
        with pytest.raises(ValueError, match="power-of-two"):
            tmh.MultihostDelta(params, fab, schedule="swing", device="cpu")
        return True

    assert run_ranks(True, 3, body, "swref") == [True] * 3


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmh.MultihostDelta(td.DeltaParams(n=64, k=64, rng="counter"), tf.Fabric(0, 1, tf.LocalKV()))


def test_jax_state_installed_across_process_counts_resets_the_codec_epoch():
    """A JAX engine state after t1 ticks, cut into the blocks of 4 ranks
    and installed (``_install_block_state``, numpy leaves): every rank's
    codec epoch bumps, and t2 more ticks equal the unbroken JAX run."""
    jparams = jd.DeltaParams(n=256, k=K, rng="counter")
    t1, t2, seed = 7, 5, 13
    _, st = engine_digest(jparams, jd.DeltaFaults(), seed, t1)
    leaves = jax.tree.map(np.asarray, st)
    ref, _ = engine_digest(jparams, jd.DeltaFaults(), seed, t1 + t2)
    tparams = td.DeltaParams(n=256, k=K, rng="counter")

    def body(fab, rank):
        mh = tmh.MultihostDelta(tparams, fab, seed=0, device="cpu")
        epoch = fab.codec_epoch
        lo, hi = process_block(256, rank, 4)
        mh._install_block_state(jd.DeltaState(learned=leaves.learned[lo:hi], pcount=leaves.pcount[lo:hi],
                                              ride_ok=leaves.ride_ok[lo:hi], tick=leaves.tick, key=leaves.key))
        assert fab.codec_epoch > epoch, "epoch not reset"
        assert mh.tick == t1
        for _ in range(t2):
            mh.step()
        return mh.state_digest()

    assert run_ranks(True, 4, body, "xp4") == [ref] * 4
