"""The JAX pin of ``chip_smoke.py``'s phase 22 (the SWIM host stack and the
facade), recomputed, and the phase's script held port against JAX.

``chip_smoke.py`` imports nothing of JAX, so what it holds the port to on
the card is a constant.  ``PIN_HOST_CLUSTER`` is ``host_cluster_run``'s
record at 128 facades: ticks to converge and to suspect the 4 victims, the
survivors' membership and ring checksums, the sha256 of every node's
sorted ``(address, status, incarnation)`` members after each tick, the ring
events node 0 saw after convergence, and the export and import.  Here the
JAX package computes it (``-m slow``, ~30 s), and in tier-1 the same
script at 32 facades runs through both packages, record for record, with
the live feed's hooks on the port's run: a ``RingStore`` on the CPU hung on
node 0's ring answers request keys through the keyed path at both
generations as the facade's ring does.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.events import RingChangedEvent, on
from ringpop_tpu.net import LocalChannel, LocalNetwork
from ringpop_tpu.options import Options
from ringpop_tpu.ringpop import Ringpop
from ringpop_tpu.sim.snapshot import export_membership, import_membership
from ringpop_tpu.swim.node import BootstrapOptions, Node, NodeOptions
from ringpop_tpu.util.clock import MockClock

from ringpop_tpu_torch.hashing import pack_strings
from ringpop_tpu_torch.ops.hash_ops import keyed_owner_lookup, upload_keys
from ringpop_tpu_torch.ops import hash_kernel
from ringpop_tpu_torch.serve.state import RingStore, serve_lookup_fused

JAX_HOST_STACK = SimpleNamespace(LocalNetwork=LocalNetwork, LocalChannel=LocalChannel, Ringpop=Ringpop,
                                 Options=Options, MockClock=MockClock, BootstrapOptions=BootstrapOptions, Node=Node,
                                 NodeOptions=NodeOptions, export_membership=export_membership,
                                 import_membership=import_membership, RingChangedEvent=RingChangedEvent, on=on)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_feed(n_keys: int):
    """The live feed's hooks on the CPU: a RingStore hung on node 0's ring,
    ``n_keys`` keys through the keyed path at each generation."""
    keys = [f"key-{i}" for i in range(n_keys)]
    dmat, dlens = upload_keys(*pack_strings(keys), device="cpu")
    seen = {"store": None, "gens": []}

    def answer(rp):
        store = seen["store"]
        ring, gen, ns = store.snapshot()
        servers = store.servers_at(gen)
        assert servers == rp.ring.servers()
        count = int(ring.count[0])
        want = [servers.index(row[0]) for row in rp.ring.lookup_n_batch(keys, 1)]
        keyed = keyed_owner_lookup(ring.tokens[:count], ring.owners[:count], dmat, dlens)
        fused = serve_lookup_fused(ring, hash_kernel.fingerprint32(dmat, dlens))
        assert keyed.tolist() == want and fused[:-1].tolist() == want and int(fused[-1]) == gen
        assert [servers[w] for w in want[:64]] == [rp.lookup(k) for k in keys[:64]]
        seen["gens"].append((gen, ns, count))
        return {"gen": gen}

    def on_converged(rps):
        seen["store"] = RingStore(rps[0].ring.servers(), replica_points=rps[0].ring.replica_points, device="cpu")
        seen["store"].listen_to(rps[0].ring)
        return answer(rps[0])

    def on_removed(rps, ring_events):
        assert seen["store"].gen == ring_events
        return answer(rps[0])

    return on_converged, on_removed, seen


def test_host_cluster_script_port_equals_jax_at_32():
    want = chip_smoke.host_cluster_run(JAX_HOST_STACK, 32)
    on_converged, on_removed, seen = cpu_feed(2048)
    got = chip_smoke.host_cluster_run(chip_smoke.port_host_stack(), 32, on_converged, on_removed)
    assert got["pin"] == want["pin"]
    pin = got["pin"]
    assert pin["n"] == 32 and pin["exported"] == pin["imported"] == 32
    assert pin["ring_events"] == len(pin["victims"]) == 4
    assert seen["gens"] == [(0, 32, 3200), (4, 28, 2800)]


@pytest.mark.slow
def test_pin_host_cluster():
    assert chip_smoke.host_cluster_run(JAX_HOST_STACK, chip_smoke.HOST_N)["pin"] == chip_smoke.PIN_HOST_CLUSTER
