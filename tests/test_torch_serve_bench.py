"""The port's paired A/B driver, ``serve.bench.run_ab``, on a CPU store.

``make serve-smoke``'s certificate at a smoke size (8 servers, 2 frontend
processes, 256-key batches, one warm and one measured rep, 32 B = 1
requests over the shared-memory ring): the frontends' owner digests
through the port's service equal their host bisect walk's, every answer
carries the pinned generation, a live update re-certifies against the
post-update oracle, the B = 1 answers match the oracle, and the journal
carries the ``ring_update`` record and a ``serve`` record for each window
of 64 flushes, with ``scripts/serve_smoke.py``'s fields.  Throughput is
not asserted: a CPU run prices nothing on the card.
"""

import pytest
import torch

from ringpop_tpu_torch.serve.bench import run_ab


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Journal:
    def __init__(self):
        self.records = []

    def _write(self, obj):
        self.records.append(obj)


def test_run_ab_certifies_over_shm_on_the_cpu():
    journal = _Journal()
    rec = run_ab(n_servers=8, frontends=2, batch=256, batches_per_rep=2, reps=1, warm_reps=1,
                 latency_reqs=32, transport="shm", seed=0, journal=journal, device="cpu")
    assert rec["digest_equal"] and rec["generation_pinned"] and rec["update_certified"]
    assert rec["latency_b1"]["owners_match_oracle"]
    assert rec["generations_seen"] == [0] and rec["update_record"]["gen"] == 1
    assert rec["keys_per_rep_per_side"] == 2 * 256 * 2
    t = rec["telemetry"]
    # every frontend key of both reps and every B = 1 request went through
    # the collector (plus each worker's 8-key warm-up)
    assert t["keys"] == 2 * 2 * 512 + 2 * 8 + 32 + 16 and t["flushes"] >= 1
    serves = [r for r in journal.records if r["kind"] == "serve"]
    updates = [r for r in journal.records if r["kind"] == "ring_update"]
    assert updates and updates[-1]["gen"] == rec["update_record"]["gen"]
    # one ``serve`` record a window of 64 flushes (the service's default)
    assert len(serves) == t["flushes"] // 64
    for r in serves:
        assert {"keys_per_flush", "queue_wait_us", "dispatch_us", "flushes", "requests", "keys", "gen"} <= set(r)
        assert {"mean", "p50", "p90", "max"} <= set(r["keys_per_flush"]) and r["flushes"] == 64


def test_run_ab_refuses_what_it_cannot_certify():
    with pytest.raises(ValueError, match="reference placement"):
        run_ab(placement="dgro", device="cpu")
    with pytest.raises(ValueError, match="transport"):
        run_ab(transport="udp", device="cpu")
