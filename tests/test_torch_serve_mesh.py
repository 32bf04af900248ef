"""The port's serve mesh (``ringpop_tpu_torch/serve/mesh.py``) against the JAX
package's, mirroring ``tests/test_serve_mesh.py``.

P ranks are threads over ``LocalKV`` sharing one device (the CPU here); each
answers through ``serve_lookup_n_fused`` on its ring.  At P = 1, 2 and 4,
with the codec on and off and with span tracing on, every rank's record —
the combined and per-stream digests, the key and message counts and
``Fabric.wire_stats()`` — equals the JAX mesh's, bar the wall-clock keys;
the P = 1 digest equals the host-walk oracle.  The tolerance is none.
"""

import numpy as np
import pytest
import torch

from ringpop_tpu.serve.mesh import run_serve_mesh as jax_run_serve_mesh

from ringpop_tpu_torch.serve.mesh import (
    ServeMesh,
    _digest_chain,
    _stream_hashes,
    run_serve_mesh,
)

CFG = dict(n_servers=8, replica_points=20, rounds=2, keys_per_stream=256, seed=3)
WALL_KEYS = ("wall_s", "keys_per_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(nprocs, **kw):
    return run_serve_mesh(nprocs, n=3, streams=4, device="cpu", **{**CFG, **kw})


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in WALL_KEYS}


def _oracle_digest(n_servers, replica_points, n, streams, rounds, keys_per_stream, seed, gen=0):
    """The single-process oracle computed outside the mesh: the port's host
    LookupN walk per key, digest-chained per stream."""
    from ringpop_tpu_torch.hashing import fingerprint32
    from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens, host_lookup_n

    servers = [f"10.21.{i // 256}.{i % 256}:3000" for i in range(n_servers)]
    toks, owns = build_ring_tokens(servers, replica_points, device="cpu")
    tokens = toks.numpy().astype(np.uint32)
    owners = owns.numpy().astype(np.int32)
    digests = {}
    for s in range(streams):
        d = 0
        for rnd in range(rounds):
            hashes = _stream_hashes(seed, s, rnd, keys_per_stream)
            rows = host_lookup_n(tokens, owners, hashes, n, n_servers)
            d = _digest_chain(d, hashes, rows, gen)
        digests[s] = d
    return fingerprint32(b"".join(digests[s].to_bytes(4, "little") for s in range(streams)))


def test_mesh_p1_matches_host_walk_oracle():
    recs = _mesh(1)
    want = _oracle_digest(CFG["n_servers"], CFG["replica_points"], 3, 4, CFG["rounds"],
                          CFG["keys_per_stream"], CFG["seed"])
    assert recs[0]["digest"] == want


@pytest.mark.parametrize("codec", [True, False], ids=["codec", "raw"])
@pytest.mark.parametrize("nprocs", [1, 2, 4])
def test_mesh_records_equal_the_jax_mesh(nprocs, codec):
    """Digests, stream digests, key and message counts and the wire stats
    (bytes, raw bytes, codec counts) of every rank == the JAX mesh's."""
    got = _mesh(nprocs, codec=codec)
    want = jax_run_serve_mesh(nprocs, n=3, streams=4, codec=codec, **CFG)
    assert [_strip(r) for r in got] == [_strip(r) for r in want]


@pytest.mark.parametrize("nprocs", [2, 4])
def test_mesh_digest_equals_single_process_oracle(nprocs):
    oracle = _mesh(1)[0]["digest"]
    recs = _mesh(nprocs)
    for rec in recs:
        assert rec["digest"] == oracle
        assert rec["stream_digests"] == recs[0]["stream_digests"]


def test_mesh_message_count_is_o_owners_not_o_keys():
    for rec in _mesh(2):
        assert rec["messages_sent"] == 2 * 1 * CFG["rounds"]
        assert rec["keys_forwarded_out"] > rec["messages_sent"]
        assert rec["messages_sent"] < rec["messages_naive"]


def test_mesh_wire_accounting_contract():
    assert _mesh(1)[0]["wire"]["bytes_sent"] == 0
    for rec in _mesh(4):
        w = rec["wire"]
        assert w["bytes_sent"] > 0 and w["bytes_recv"] > 0
        assert w["bytes_sent"] <= w["raw_bytes_sent"]
        assert w["bytes_recv"] <= w["raw_bytes_recv"]


def test_mesh_block_ownership_covers_ring_exactly():
    from ringpop_tpu_torch.forward.batch import rank_of_hashes
    from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens
    from ringpop_tpu_torch.parallel.partition import process_block

    servers = [f"10.21.0.{i}:3000" for i in range(8)]
    toks, _ = build_ring_tokens(servers, 20, device="cpu")
    tokens = toks.numpy().astype(np.uint32)
    count = tokens.shape[0]
    blocks = [process_block(count, r, 4) for r in range(4)]
    assert blocks[0][0] == 0 and blocks[-1][1] == count
    for (_, hi), (lo, _) in zip(blocks, blocks[1:]):
        assert hi == lo
    hashes = np.random.default_rng(0).integers(0, 2**32, size=512, dtype=np.uint32)
    ranks = rank_of_hashes(tokens, hashes, 4)
    idx = np.searchsorted(tokens, hashes, side="left")
    idx = np.where(idx >= count, 0, idx)
    for h_idx, r in zip(idx, ranks):
        lo, hi = blocks[r]
        assert lo <= h_idx < hi


def test_mesh_refuses_non_divisible_workload_and_ring():
    with pytest.raises(ValueError):
        _mesh(3)  # streams % P != 0
    from ringpop_tpu_torch.parallel.fabric import LocalKV

    with pytest.raises(ValueError):
        ServeMesh(0, 7, [f"s{i}:1" for i in range(8)], replica_points=20, streams=7, kv=LocalKV(), device="cpu")


def test_mesh_codec_off_digest_identical():
    on = _mesh(2, codec=True)
    off = _mesh(2, codec=False)
    assert on[0]["digest"] == off[0]["digest"]
    for a, b in zip(on, off):
        assert a["wire"]["bytes_sent"] <= b["wire"]["bytes_sent"]


def _span_key(rec):
    return {k: v for k, v in rec.items() if k not in ("t", "dur_ms")}


def test_mesh_digests_bit_identical_with_spans_enabled():
    """A traced P = 2 mesh lands the untraced digests, its answer spans join
    their request spans across ranks, and the span records equal the JAX
    mesh's (ids, legs, keys, generations) bar their clock readings."""
    records, jrecords = [], []
    traced = _mesh(2, trace_sink=records.append, trace_sample=16)
    jtraced = jax_run_serve_mesh(2, n=3, streams=4, trace_sink=jrecords.append, trace_sample=16, **CFG)
    oracle = _mesh(1)[0]["digest"]
    assert {r["digest"] for r in traced} == {oracle}
    assert [_strip(r) for r in traced] == [_strip(r) for r in jtraced]
    order = lambda recs: sorted((_span_key(r) for r in recs), key=lambda r: (r["span"], r["leg"]))
    assert order(records) == order(jrecords)
    reqs = {r["span"]: r for r in records if r["leg"] == "mesh_request"}
    answers = [r for r in records if r["leg"] == "mesh_answer"]
    assert reqs and answers
    for a in answers:
        mate = reqs.get(a["parent"])
        assert mate is not None and mate["trace"] == a["trace"]
        assert a["gen"] == 0
        assert (mate["rank"], mate["dest"]) == (a["src"], a["rank"])
        assert mate["rnd"] == a["rnd"]


def test_mesh_generation_check_is_a_raise():
    """A ring answering another generation than the rank holds fails the
    round loudly (the digest certificate's guard)."""
    from ringpop_tpu_torch.parallel.fabric import LocalKV

    mesh = ServeMesh(0, 1, [f"10.21.0.{i}:3000" for i in range(4)], replica_points=8, kv=LocalKV(),
                     namespace="gen-check", device="cpu")
    try:
        mesh.gen = 5
        with pytest.raises(RuntimeError, match="generation"):
            mesh._answer(np.arange(3, dtype=np.uint32))
    finally:
        mesh.close()
