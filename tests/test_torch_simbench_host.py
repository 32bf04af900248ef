"""The simbench twin's host-plane rows against the JAX package's, on the
CPU at simbench's non-full sizes: ``host10`` (10 ``Node``s over TCP),
``forward`` (keyed requests through ``handle_or_forward`` on 3 facades over
TCP), ``forward_comparator`` (the minimal asyncio proxy) and
``forward_ab`` (the two in paired reps).  Both packages' rows are
torch-free here.

Every field of the two records is held equal but these:

- walls and rates: ``value`` of every row, ``failure_detect_s``
  (``host10``), ``qps_reps`` (``forward``, ``forward_comparator``),
  ``ratio_reps``, ``forward_qps_reps``, ``comparator_qps_reps`` and
  ``protocol_overhead_pct_median`` (``forward_ab``); each list's length is
  held;
- ``forward``'s ``handled_locally`` and ``forwarded``: the split depends on
  the ring, which hashes each node's ``host:port``, and the nodes bind
  ephemeral ports; their sum is held to ``n_requests``.
"""

import pytest
import torch

from ringpop_tpu.cli import simbench as jsb
from ringpop_tpu_torch.cli import simbench as tsb
from torch_simbench_compare import assert_rows_match

SEED = 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RATES = {
    "host10": {"value": "s to converge, host clock", "failure_detect_s": "host clock"},
    "forward": {"value": "req/s", "qps_reps": "req/s", "handled_locally": "the ring hashes ephemeral ports",
                "forwarded": "the ring hashes ephemeral ports"},
    "forward_comparator": {"value": "req/s", "qps_reps": "req/s"},
    "forward_ab": {"value": "a ratio of rates", "ratio_reps": "ratios of rates", "forward_qps_reps": "req/s",
                   "comparator_qps_reps": "req/s", "protocol_overhead_pct_median": "a ratio of rates"},
}


@pytest.mark.parametrize("row", list(RATES))
def test_host_row(row):
    want = jsb.BENCHES[row](SEED, False)
    got = tsb.BENCHES[row](SEED, False)
    assert_rows_match(want, got, RATES[row])
    for key in RATES[row]:
        if isinstance(want[key], list):
            assert len(got[key]) == len(want[key]), key
    if row == "host10":
        assert got["converged"] and got["detected"]
    if row == "forward":
        assert got["handled_locally"] + got["forwarded"] == got["n_requests"] == want["n_requests"]
        assert 0 < got["handled_locally"] < got["n_requests"]
