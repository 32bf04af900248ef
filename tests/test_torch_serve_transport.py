"""The port's serve transports against the JAX package.

* The wire is unchanged: the fabric's array codec (raw, rows, runs and
  the XOR delta), ``frame_array``, the channel's array lanes under each
  codec and a channel request as it crosses the socket give the JAX
  package's bytes.
* The JAX package's own ``ServeClient`` and ``ShmClient`` talk to the
  port's ``ServiceThread`` and get the host oracle's owners.
* The shared-memory slot protocol of ``tests/test_transport_plane.py``
  holds on the port's ``ShmServer``/``ShmClient``: read-only views of the
  slots, a slot not republished until its dispatch consumed it, the
  sequence word's wrap-around, a retry while a dispatch holds the slot,
  STATUS_ERR republication after a failed scan.
* The frontend modules import with neither torch nor jax loaded.
"""

import asyncio
import base64
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import ringpop_tpu.net.channel as jch
import ringpop_tpu.parallel.fabric as jfab
from ringpop_tpu.serve.client import HostBisectFrontend as JaxBisect
from ringpop_tpu.serve.client import ServeClient as JaxServeClient
from ringpop_tpu.serve.shm import ShmClient as JaxShmClient

import ringpop_tpu_torch.net.channel as tch
import ringpop_tpu_torch.parallel.fabric as tfab
from ringpop_tpu_torch.serve import state as tst
from ringpop_tpu_torch.serve.bench import ServiceThread
from ringpop_tpu_torch.serve.shm import (
    _COUNT,
    _GEN,
    _N,
    _REQ_SEQ,
    _RESP_SEQ,
    _STATUS,
    STATUS_ERR,
    STATUS_OK,
    ShmClient,
    ShmServer,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVERS = [f"10.7.0.{i}:3000" for i in range(24)]


def _arrays():
    """Payloads for each of the codec's lanes: dense (raw), zero rows
    (rows), patchy words (runs), an empty one and a scalar."""
    rng = np.random.default_rng(3)
    dense = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    rows = np.zeros((256, 4), np.uint32)
    rows[rng.choice(256, 9, replace=False)] = rng.integers(1, 2**32, (9, 4), dtype=np.uint32)
    runs = np.zeros(4096, np.uint32)
    runs[100:140] = 7
    runs[3000:3003] = 2**31
    return {"dense": dense, "rows": rows, "runs": runs, "int32": dense.view(np.int32)[:5],
            "empty": np.zeros(0, np.uint32), "int8": rng.integers(-128, 128, 300).astype(np.int8)}


@pytest.mark.parametrize("name", sorted(_arrays()))
def test_fabric_codec_gives_the_jax_packages_bytes(name):
    a = _arrays()[name]
    for rows in (True, False):
        want = jfab.encode_array(a, rows=rows)
        got = tfab.encode_array(a, rows=rows)
        assert (got.codec, got.dtype, got.shape, got.payload, got.raw_nbytes) == tuple(want)
        assert np.array_equal(tfab.decode_array(got.codec, got.dtype, got.shape, got.payload), a)
    framed = tfab.frame_array(a)
    assert framed == jfab.frame_array(a)
    back = tfab.unframe_array(framed)
    assert back.dtype == a.dtype and np.array_equal(back, a)
    # the XOR delta against the previous payload on a stream
    prev = np.zeros_like(a)
    want = jfab.encode_array(a, prev=prev.tobytes(), epoch=5)
    got = tfab.encode_array(a, prev=prev.tobytes(), epoch=5)
    assert tuple(got) == tuple(want)
    assert np.array_equal(tfab.decode_array(got.codec, got.dtype, got.shape, got.payload,
                                            prev=prev.tobytes(), epoch=5), a)


@pytest.mark.parametrize("codec", ["json", "msgpack"])
def test_channel_array_lanes_give_the_jax_packages_bytes(codec):
    if tch._msgpack is None and codec == "msgpack":
        with pytest.raises(ValueError, match="msgpack"):
            tch.TCPChannel(codec="msgpack")
        return
    for a in _arrays().values():
        flat = a.reshape(-1)
        for dtype in ("<u4", "<i4"):
            if flat.dtype.itemsize != 4:
                continue
            for fabric in (False, True):
                want = jch.encode_array(flat, codec, dtype, fabric=fabric)
                got = tch.encode_array(flat, codec, dtype, fabric=fabric)
                assert got == want
                assert np.array_equal(tch.decode_array(got, dtype), jch.decode_array(want, dtype))
    frame = {"id": 7, "kind": "req", "svc": "serve", "ep": "/lookup",
             "body": {"h": tch.encode_array(np.arange(9, dtype=np.uint32), codec), "n": 3}, "headers": {}}
    enc = tch._encoder_for(codec)
    assert enc(frame) == jch._encoder_for(codec)(frame)
    assert tch._decode_frame_body(memoryview(enc(frame))) == frame


def _capture_request(ch_mod, codec: str) -> bytes:
    """The bytes a channel's request puts on the socket: one fabric frame
    (16-byte header, the body) read by a bare listening socket."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    got = {}

    def accept():
        conn, _ = srv.accept()
        conn.settimeout(10)
        data = b""
        while len(data) < jfab._HDR.size or len(data) < jfab._HDR.size + jfab._HDR.unpack_from(data)[2]:
            chunk = conn.recv(65536)
            if not chunk:
                break
            data += chunk
        got["wire"] = data
        conn.close()

    t = threading.Thread(target=accept)
    t.start()

    async def call():
        chan = ch_mod.TCPChannel(app="wire", codec=codec)
        body = {"h": ch_mod.encode_array(np.arange(33, dtype=np.uint32), codec), "n": 2}
        with pytest.raises(ch_mod.CallError):
            await chan.call(f"127.0.0.1:{port}", "serve", "/lookup", body, timeout=0.5)
        await chan.close()

    try:
        asyncio.run(call())
        t.join(timeout=10)
    finally:
        srv.close()
    assert not t.is_alive()
    return got["wire"]


@pytest.mark.parametrize("codec", ["json", "msgpack"])
def test_an_rpc_request_on_the_wire_is_the_jax_packages(codec):
    if tch._msgpack is None and codec == "msgpack":
        pytest.skip("msgpack is not importable here")
    wire = _capture_request(tch, codec)
    assert wire == _capture_request(jch, codec)
    tag, blobs, length = tfab._HDR.unpack_from(wire)
    assert tag & tfab._RPC_KIND_MASK == tfab.TAG_RPC_REQ and blobs == 1
    assert len(wire) == tfab._HDR.size + length


@pytest.fixture
def service_thread():
    store = tst.RingStore(SERVERS, replica_points=10, device="cpu")
    th = ServiceThread(store, flush_us=0.0, shm_slots=2, shm_key_cap=4096, shm_max_n=4)
    th.start()
    yield th
    th.stop()


def _hashes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint32)


def test_jax_clients_against_the_port_service(service_thread):
    """The JAX package's frontends speak to the port's service unchanged:
    TCP (one owner, three owners, the generation's server list) and the
    shared-memory ring (the collector lane and the B = 1 direct lane)."""
    th = service_thread
    h = _hashes(96, seed=11)
    oracle = JaxBisect(SERVERS, 10)

    async def tcp():
        chan = jch.TCPChannel(app="t")
        client = JaxServeClient(chan, th.hostport)
        owners, gen = await client.lookup_hashes(h)
        servers = await client.servers_at(gen)
        o3, g3 = await client.lookup_hashes(h[:8], n=3)
        resolved = await client.lookup(h[:4])
        await chan.close()
        return owners, gen, servers, o3, resolved

    owners, gen, servers, o3, resolved = asyncio.run(tcp())
    assert gen == 0 and servers == sorted(SERVERS)
    assert np.array_equal(owners, oracle.lookup_hashes(h))
    assert np.array_equal(o3[:, 0], owners[:8]) and o3.shape == (8, 3)
    assert resolved == [servers[o] for o in owners[:4]]

    name, sock, slots, cap, max_n = th.shm_address()
    got = {}

    def shm():
        cl = JaxShmClient(name, sock, 1, slots=slots, key_cap=cap, max_n=max_n)
        got["big"] = cl.lookup_hashes(_hashes(600, seed=5))
        got["one"] = cl.lookup_hashes(h[:1])
        got["n3"] = cl.lookup_hashes(h[:8], n=3)
        cl.close()

    c = threading.Thread(target=shm)
    c.start()
    c.join(timeout=60)
    assert not c.is_alive()
    assert np.array_equal(got["big"][0], oracle.lookup_hashes(_hashes(600, seed=5))) and got["big"][1] == 0
    assert np.array_equal(got["one"][0], owners[:1])
    assert np.array_equal(got["n3"][0], o3)


# -- the shared-memory slot protocol on the port ------------------------------


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class _CapturingService:
    """RingService stand-in: records what the shm server hands it.  A lone
    small request (<= 64 keys, nothing queued) goes through
    ``dispatch_direct``, everything else through ``submit_nowait`` +
    ``flush_now``."""

    def __init__(self):
        self._pending = []
        self.submitted = []
        self.direct = []
        self.answer_on_flush = True
        self.raise_on_flush = None

    def submit_nowait(self, hashes, n, callback, loop=None):
        self.submitted.append((hashes, n, callback))
        self._pending.append((hashes, n, callback))

    def flush_now(self):
        if self.raise_on_flush is not None:
            raise self.raise_on_flush
        if not self.answer_on_flush:
            return  # the dispatch "holds" the slot views
        pend, self._pending[:] = list(self._pending), []
        for hashes, n, cb in pend:
            cb(np.zeros(len(hashes) * n, np.int32), 7)

    def dispatch_direct(self, hashes, n, callback):
        self.direct.append((hashes, n, callback))
        callback(np.zeros(len(hashes) * n, np.int32), 7)


def _post(server, slot, hashes, n=1):
    """Write a request into a slot the way ShmClient does; returns req."""
    ring = server.ring
    hdr = ring._headers[slot]
    ring._hashes[slot][: len(hashes)] = hashes
    hdr[_COUNT] = np.uint32(len(hashes))
    hdr[_N] = np.uint32(n)
    req = (int(hdr[_REQ_SEQ]) + 1) & 0xFFFFFFFF
    hdr[_REQ_SEQ] = np.uint32(req)
    return req


def test_shm_scan_hands_the_collector_a_shared_readonly_view():
    svc = _CapturingService()
    server = ShmServer(svc, slots=2, key_cap=256, max_n=2)
    try:
        hashes = np.arange(100, dtype=np.uint32) + 5
        _post(server, 0, hashes)
        assert server.scan() == 1
        (got, n, _cb), = svc.submitted
        assert n == 1 and np.shares_memory(got, server.ring._hashes[0]) and not got.flags.writeable
        assert np.array_equal(got, hashes)
        row = server.ledger.stats()["classes"]["shm"]
        assert row["copy_bytes"] == 0
        assert row["bytes_recv"] == hashes.nbytes and row["frames_recv"] == 1
        hdr = server.ring._headers[0]
        assert int(hdr[_RESP_SEQ]) == int(hdr[_REQ_SEQ]) and int(hdr[_STATUS]) == STATUS_OK
        assert row["bytes_sent"] == hashes.nbytes and row["frames_sent"] == 1
        del got, hdr
        svc.submitted.clear()
    finally:
        server.close()


def test_shm_direct_lane_is_zero_copy_too():
    svc = _CapturingService()
    server = ShmServer(svc, slots=1, key_cap=256, max_n=2)
    try:
        _post(server, 0, np.arange(8, dtype=np.uint32), n=2)
        assert server.scan() == 1
        (got, n, _cb), = svc.direct
        assert n == 2 and np.shares_memory(got, server.ring._hashes[0]) and not got.flags.writeable
        assert server.ledger.stats()["copy_bytes"] == 0
        del got
        svc.direct.clear()
    finally:
        server.close()


def test_shm_slot_not_republished_until_dispatch_consumes():
    svc = _CapturingService()
    svc.answer_on_flush = False
    server = ShmServer(svc, slots=2, key_cap=256, max_n=1)
    try:
        req = _post(server, 0, np.arange(100, dtype=np.uint32))
        server.scan()
        hdr = server.ring._headers[0]
        assert int(hdr[_RESP_SEQ]) != req and 0 in server._inflight
        (_got, _n, cb), = svc._pending
        svc._pending.clear()
        cb(np.zeros(100, np.int32), 3)
        assert int(hdr[_RESP_SEQ]) == req and 0 not in server._inflight and int(hdr[_GEN]) == 3
        del _got, hdr
        svc.submitted.clear()
    finally:
        server.close()


def test_shm_seq_word_wraparound():
    svc = _CapturingService()
    server = ShmServer(svc, slots=1, key_cap=64, max_n=1)
    name, sock_path = server.address
    client = ShmClient(name, sock_path, 0, slots=1, key_cap=64, max_n=1, timeout=5.0, spin_us=50.0)
    client._hdr[_REQ_SEQ] = np.uint32(0xFFFFFFFF)
    client._hdr[_RESP_SEQ] = np.uint32(0xFFFFFFFF)
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            if server.scan() == 0:
                time.sleep(0.0005)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        for _ in range(3):  # crosses the wrap on the first post
            owners, gen = client.lookup_hashes(np.arange(4, dtype=np.uint32))
            assert owners.shape == (4,) and gen == 7
        assert int(client._hdr[_REQ_SEQ]) == 2  # 0xFFFFFFFF -> 0 -> 1 -> 2
    finally:
        stop.set()
        t.join(2)
        svc.direct.clear()  # drop the slot views before the segment closes
        client.close()
        server.close()
    assert not t.is_alive()


def test_shm_retry_while_dispatch_holds_slot():
    svc = _CapturingService()
    svc.answer_on_flush = False
    server = ShmServer(svc, slots=1, key_cap=256, max_n=1)

    async def main():
        server.attach(asyncio.get_event_loop())
        old_req = _post(server, 0, np.arange(100, dtype=np.uint32))
        server.scan()
        assert 0 in server._inflight
        new_req = _post(server, 0, np.arange(100, dtype=np.uint32) + 7)
        assert new_req != old_req
        (_got, _n, cb), = svc._pending
        svc._pending.clear()
        svc.answer_on_flush = True
        cb(np.zeros(100, np.int32), 7)
        hdr = server.ring._headers[0]
        assert int(hdr[_RESP_SEQ]) == old_req
        for _ in range(50):
            await asyncio.sleep(0.01)
            if int(hdr[_RESP_SEQ]) == new_req:
                break
        assert int(hdr[_RESP_SEQ]) == new_req, "retry stranded: rescan missing"
        assert len(svc.submitted) == 2
        assert np.array_equal(svc.submitted[1][0], np.arange(100, dtype=np.uint32) + 7)
        svc.submitted.clear()

    try:
        _run(main())
    finally:
        server._loop = None
        server.close()


def test_shm_status_err_republication_on_mid_scan_exception():
    svc = _CapturingService()
    svc.raise_on_flush = RuntimeError("deliberate poison")
    server = ShmServer(svc, slots=2, key_cap=256, max_n=1)
    try:
        r0 = _post(server, 0, np.arange(70, dtype=np.uint32))
        r1 = _post(server, 1, np.arange(70, dtype=np.uint32))
        server.scan()
        for s, req in ((0, r0), (1, r1)):
            hdr = server.ring._headers[s]
            assert int(hdr[_RESP_SEQ]) == req and int(hdr[_STATUS]) == STATUS_ERR
        assert not server._inflight
        svc.raise_on_flush = None
        svc._pending.clear()
        r0b = _post(server, 0, np.arange(70, dtype=np.uint32))
        server.scan()
        hdr = server.ring._headers[0]
        assert int(hdr[_RESP_SEQ]) == r0b and int(hdr[_STATUS]) == STATUS_OK
        del hdr
        svc.submitted.clear()
        svc._pending.clear()
    finally:
        server.close()


def test_frontend_modules_import_without_torch_or_jax():
    """A frontend process imports the transport modules, and decodes a
    fabric-lane array, with neither torch nor jax loaded."""
    mods = ["ringpop_tpu_torch.errors", "ringpop_tpu_torch.net.channel", "ringpop_tpu_torch.parallel.fabric",
            "ringpop_tpu_torch.serve.shm", "ringpop_tpu_torch.serve.client", "ringpop_tpu_torch.obs.trace",
            "ringpop_tpu_torch.util.metrics", "ringpop_tpu_torch.logging", "ringpop_tpu_torch.serve.bench"]
    code = (
        "import importlib, sys, numpy as np\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from ringpop_tpu_torch.net.channel import encode_array, decode_array\n"
        "v = encode_array(np.arange(512, dtype=np.uint32), 'json', fabric=True)\n"
        "assert (decode_array(v) == np.arange(512)).all()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'ringpop_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_msgpack_leg_is_refused_with_the_jax_packages_error(monkeypatch):
    """Where msgpack is missing (the card's machine), asking for it raises
    the JAX package's own error; nothing falls back to json."""
    monkeypatch.setattr(tch, "_msgpack", None)
    with pytest.raises(ValueError, match="msgpack codec requested but msgpack is not importable"):
        tch.TCPChannel(codec="msgpack")
    assert tch._decode_frame_body(memoryview(b"\xc1\x00\x00\x00\x01\x80")) is None
    assert base64.b64decode(tch.encode_array(np.arange(3, dtype=np.uint32), "json")) == (
        np.arange(3, dtype="<u4").tobytes())
