"""The port's multi-host delta over real OS processes on the CPU: rank
processes started by ``ringpop_tpu_torch.cli.multihost_launch``, each running
``ringpop_tpu_torch.cli.multihost_bench`` on the host (``--device cpu``),
joined by a gloo process group and the fabric over ``DistributedKV``.

simbench ``multihost16m``'s legs at a small size, against the JAX engine
run unsharded in this process: the P = 2 twin (victims and loss), the P = 2
save at tick 16 (victims) and its restore at P = 4, continued 8 ticks to the
unbroken run's digest.  One small group a leg (~8–12 s each, mostly the
processes' start).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim.telemetry import tree_digest
from ringpop_tpu_torch.cli import multihost_launch

N, K, SEED, VICTIMS, DROP = 1024, 64, 0, 16, 0.05
BENCH = ["-m", "ringpop_tpu_torch.cli.multihost_bench"]
COMMON = ["--n", str(N), "--k", str(K), "--seed", str(SEED), "--victims", str(VICTIMS)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _one_thread_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the rank processes inherit it


def launch(nprocs, argv):
    ranks = multihost_launch.launch(nprocs, BENCH + argv, timeout_s=240, device="cpu")
    return [r["records"][-1] for r in ranks]


def jax_digests(ticks, drop, at=()):
    """The JAX engine's digest after ``ticks`` (and after each tick in
    ``at``) at the bench's victims."""
    params = jd.DeltaParams(n=N, k=K, rng="counter")
    rng = np.random.default_rng(SEED + 999)
    up = np.ones(N, bool)
    up[rng.choice(N, size=VICTIMS, replace=False)] = False
    faults = jd.DeltaFaults(up=jnp.asarray(up), **({"drop_rate": jnp.float32(drop)} if drop else {}))
    stp = jax.jit(functools.partial(jd.step, params))
    st = jd.init_state(params, seed=SEED)
    out = {}
    for t in range(1, ticks + 1):
        st = stp(st, faults)
        if t in at:
            out[t] = int(tree_digest(st))
    out[ticks] = int(tree_digest(st))
    return out


def test_two_process_twin_equals_the_jax_engine():
    recs = launch(2, ["twin", *COMMON, "--drop", str(DROP), "--ticks", "24"])
    want = jax_digests(24, DROP)[24]
    assert [r["digest"] for r in recs] == [want, want]
    assert [r["process_id"] for r in recs] == [0, 1] and {r["process_count"] for r in recs} == {2}
    assert all(r["fabric_bytes_sent"] > 0 and r["device_peak_mb"] is None for r in recs)


def test_two_process_save_restored_at_four_equals_the_unbroken_run(tmp_path):
    path = str(tmp_path / "ckpt")
    want = jax_digests(24, 0.0, at=(16,))
    saved = launch(2, ["snapshot-save", *COMMON, "--ticks", "16", "--path", path])
    assert [(r["tick"], r["digest"]) for r in saved] == [(16, want[16])] * 2
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["shard-00000.npz", "shard-00001.npz"]
    restored = launch(4, ["snapshot-restore", *COMMON, "--extra-ticks", "8", "--path", path])
    assert [(r["tick"], r["digest_at_restore"], r["digest"]) for r in restored] == [(24, want[16], want[24])] * 4
