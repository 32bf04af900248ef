"""The simbench twin's serve rows against the JAX package's, on the CPU at
simbench's non-full sizes, seed 0: ``serve_ring`` (4 frontend processes
over the shared-memory ring against their host bisect walks, and the DGRO
placement score), ``serve_fanin`` (the serve mesh at P = 1, 2, 4 and the
quorum harness) and ``gameday`` (the zone cut with and without the
controller, and the bare fleet).

Every field of the two records is held equal but these, which depend on
the host's clock:

- ``serve_ring``: ``value``, ``speedup_median``, ``ratio_reps``, the
  ``*_qps_reps`` and ``*_qps_median`` (rates), ``latency_b1``'s
  microseconds and their ratio, and the collector's ``telemetry.flushes``
  and ``keys_per_flush_mean`` (its latency trigger is a host-clock
  deadline);
- ``serve_fanin``: ``value`` and each point's ``wall_s_max`` and
  ``keys_per_s_*`` (rates).

Every certificate, digest, message count, wire byte count, quorum figure
and game-day tick is held.
"""

import pytest
import torch

from ringpop_tpu.cli import simbench as jsb
from ringpop_tpu_torch.cli import simbench as tsb
from torch_simbench_compare import assert_rows_match

SEED = 0
CPU = torch.device("cpu")

INEXACT = {
    "serve_ring": {
        "value": "qps ratio", "speedup_median": "qps ratio", "ratio_reps": "qps ratios",
        "serve_qps_reps": "qps", "bisect_qps_reps": "qps", "serve_qps_median": "qps", "bisect_qps_median": "qps",
        "latency_b1.direct_dispatch_p50_us": "host clock", "latency_b1.serve_p50_us": "host clock",
        "latency_b1.serve_p90_us": "host clock", "latency_b1.ratio_p50": "host clock",
        "telemetry.flushes": "the collector's flushes follow its latency trigger, a host-clock deadline",
        "telemetry.keys_per_flush_mean": "keys over those flushes",
    },
    "serve_fanin": {
        "value": "keys/s", "scaling_curve.wall_s_max": "host clock", "scaling_curve.keys_per_s_aggregate": "keys/s",
        "scaling_curve.keys_per_s_per_host": "keys/s",
    },
    "gameday": {},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("row", list(INEXACT))
def test_serve_row(row):
    want = jsb.BENCHES[row](SEED, False)
    got = tsb.BENCHES[row](SEED, False, device=CPU)
    assert_rows_match(want, got, INEXACT[row])
    assert got["certified"] is True
