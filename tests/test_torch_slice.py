"""The keyed-ownership slice end to end: PyTorch port against the JAX package.

Key bytes -> Fingerprint32 -> ring lookup (1 owner and N owners) -> the
serve tier's capacity-padded, generation-stamped ring with a churn commit,
at a small size (512 servers x 256 vnodes, 20k keys of mixed lengths 0-64)
on the CPU, bit for bit against the JAX package.  Also: importing the port
loads neither JAX nor any ``ringpop_tpu`` module, and its state-creating
entry points raise without a card unless the caller asks for the CPU.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ringpop_tpu.hashing.farm import pack_strings as jax_pack_strings
from ringpop_tpu.ops.hash_ops import keyed_owner_lookup as jax_keyed_owner_lookup
from ringpop_tpu.ops.ring_ops import build_ring_tokens as jax_build_ring_tokens
from ringpop_tpu.ops.ring_ops import ring_lookup_n as jax_ring_lookup_n
from ringpop_tpu.serve import state as jst

from ringpop_tpu_torch.hashing.farm import pack_strings
from ringpop_tpu_torch.ops import hash_kernel, hash_ops, ring_ops
from ringpop_tpu_torch.serve import state as tst


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parent.parent


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 65, size=n)
    return [bytes(rng.integers(0, 256, size=int(L), dtype=np.uint8)) for L in lens]


def test_slice_end_to_end_matches_jax():
    servers = [f"10.0.{i // 256}.{i % 256}:3000" for i in range(512)]
    keys = _keys(11, 20_000)
    mat, lens = pack_strings(keys)
    jmat, jlens = jax_pack_strings(keys)
    assert np.array_equal(mat, jmat) and np.array_equal(lens, jlens)

    jt, jo = jax_build_ring_tokens(servers, 256)
    tokens, owners = ring_ops.build_ring_tokens(servers, 256, device="cpu")
    assert np.array_equal(tokens.numpy(), np.asarray(jt).astype(np.int64))
    dmat, dlens = hash_ops.upload_keys(mat, lens, device="cpu")
    got = hash_ops.keyed_owner_lookup(tokens, owners, dmat, dlens)
    assert np.array_equal(got.numpy(), np.asarray(jax_keyed_owner_lookup(jt, jo, mat, lens)))

    hashes = hash_kernel.fingerprint32(dmat, dlens)
    jhashes = jnp.asarray(hashes.numpy().astype(np.uint32))
    got_n = ring_ops.ring_lookup_n(tokens, owners, hashes, 3, len(servers))
    assert np.array_equal(got_n.numpy(), np.asarray(jax_ring_lookup_n(jt, jo, jhashes, 3, len(servers))))

    store = tst.RingStore(servers, replica_points=256, device="cpu")
    jstore = jst.RingStore(servers, replica_points=256)
    churn = ([f"10.9.0.{i}:3000" for i in range(5)], servers[:5])
    for step in range(2):
        if step:
            assert store.update(*churn) == jstore.update(*churn)
        ring, gen, ns = store.snapshot()
        jring, jgen, jns = jstore.snapshot()
        assert (gen, ns) == (jgen, jns) == (step, 512)
        fused = tst.serve_lookup_fused(ring, hashes)
        assert np.array_equal(fused.numpy(), np.asarray(jst.serve_lookup_fused(jring, jhashes)))
        fused_n = tst.serve_lookup_n_fused(ring, ns, hashes, 3)
        assert np.array_equal(fused_n.numpy(), np.asarray(jst.serve_lookup_n_fused(jring, jns, jhashes, 3)))
        assert int(fused_n[-1]) == step


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of ringpop_tpu_torch in a fresh interpreter."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "ringpop_tpu_torch").rglob("*.py")
    )
    for m in ("ops.hash_kernel", "ops.packbits_kernel", "ops.lifecycle_kernel", "ops.threefry_kernel",
              "ops.telemetry_kernel", "sim.delta", "sim.lifecycle", "sim.threefry", "sim.telemetry", "sim.chaos",
              "sim.topology", "sim.montecarlo", "sim.scenarios", "sim.snapshot", "options", "obs.flight", "swim.member",
              "bench", "errors", "logging", "util.metrics", "obs.trace", "parallel.fabric", "net.channel",
              "serve.client", "serve.shm", "serve.service", "serve.bench", "parallel.partition", "parallel.mesh",
              "parallel.shift", "parallel.multihost"):
        assert f"ringpop_tpu_torch.{m}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ringpop_tpu' or m.startswith('ringpop_tpu.')]\n"
        "print(len(bad), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parallel_package_imports_without_torch():
    """``ringpop_tpu_torch.parallel`` stays import-free: the serve tier's
    frontends reach ``parallel.fabric`` through it without starting torch,
    and the sharding modules beside it (partition, mesh, shift,
    multihost) load only when named."""
    code = (
        "import sys\n"
        "import ringpop_tpu_torch.parallel, ringpop_tpu_torch.parallel.fabric\n"
        "bad = [m for m in sys.modules if m == 'torch' or m.startswith('torch.') or m == 'jax'\n"
        "       or m.startswith('jax.') or m == 'ringpop_tpu' or m.startswith('ringpop_tpu.')]\n"
        "print(len(bad), bad[:5])\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_state_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    servers = ["10.0.0.1:3000", "10.0.0.2:3000"]
    mat, lens = pack_strings([b"key"])
    calls = [
        lambda device: ring_ops.build_ring_tokens(servers, 4, device=device),
        lambda device: tst.device_ring(np.array([5], np.uint32), np.array([0], np.int32), 4, device=device),
        lambda device: tst.device_ring_from_numpy(
            np.array([5], np.uint32), np.array([0], np.int32), [1], [0], device=device),
        lambda device: tst.RingStore(servers, replica_points=4, device=device),
        lambda device: hash_ops.upload_keys(mat, lens, device=device),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call("cuda")
        call("cpu")  # the plain path, asked for by name
