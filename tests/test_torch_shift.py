"""The port's shift exchange legs (``ringpop_tpu_torch/parallel/shift.py``)
over spawned gloo ranks on the CPU, against ``torch.roll`` and the JAX
package's ``parallel.shift`` on a (P, 1) virtual mesh.

One group of P ranks (P = 2 and 4) runs every case of the module:
``shard_roll`` of an int32 plane and an int vector and the two-leg
``shard_roll_pipelined``, at H = 1, 2, 4 and every shift in [0, n), shifts
>= n and negative ones (the mod-n contract), gathered whole.  The send
counter must read, per leg and rolled leaf, the send plan's non-local
entries: H + 1 at most, exactly H + 1 in the worst class at 4 ranks, and
at most 2 when H falls back to 1 (a block that H does not divide).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from ringpop_tpu.parallel import shift as jshift

from torch_dist_worker import run_group

HS = (1, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planes(n, w=3):
    x = np.arange(n * w, dtype=np.int32).reshape(n, w) * 7 + 1
    v = np.arange(n, dtype=np.int64) * 3
    learned = x ^ np.int32(0x5A5A)
    ride = (x * np.int32(1103515245)) | np.int32(1)
    return x, v, learned, ride


def _shifts(n):
    return list(range(n)) + [n, n + 3, 2 * n + 5, -1, -n, -n - 7, 3 * n + 3]


def _payload(n, hs):
    x, v, learned, ride = _planes(n)
    return {"n": n, "x": x, "v": v, "learned": learned, "ride": ride, "hs": hs, "shifts": _shifts(n)}


# the main cases: n = 64 (blocks of 32 and 16); the fallback: blocks of 10, H = 4
N_MAIN = 64


@functools.lru_cache(maxsize=None)
def _group(p):
    return run_group(p, [("main", "rolls", _payload(N_MAIN, HS)),
                         ("fallback", "rolls", _payload(10 * p, (4,)))])


@functools.lru_cache(maxsize=None)
def _jax_mesh(p):
    return Mesh(np.asarray(jax.devices("cpu")[:p]).reshape(p, 1), ("node", "rumor"))


@functools.lru_cache(maxsize=None)
def _jax_roll(p, h):
    mesh = _jax_mesh(p)
    return jax.jit(lambda x, v, s: jshift.shard_roll((x, v), s, mesh, "node", (JP("node", "rumor"), JP("node")), h=h))


@functools.lru_cache(maxsize=None)
def _jax_pipelined(p, h):
    mesh = _jax_mesh(p)
    return jax.jit(lambda x, v, lrn, rd, s: jshift.shard_roll_pipelined(
        (x, v), s, mesh, "node", (JP("node", "rumor"), JP("node")), carry=(lrn, rd),
        carry_specs=(JP("node", "rumor"), JP("node", "rumor")),
        leg2_of=lambda inb, gp, l, r: (l | inb) & r, spec2=JP("node", "rumor"), h=h))


def _plan_sends(n, p, h, shift):
    """Non-local entries of the JAX package's send plan for this shift: the
    sends a leg must post for each rolled leaf."""
    nb = n // p
    h = h if nb % h == 0 else 1
    sub = nb // h
    hq = (shift % n) // sub
    return sum(1 for ring, _ in jshift._window_plan(hq, h, p) if ring)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("h", HS)
def test_shard_roll_equals_torch_roll(p, h):
    x, v, _, _ = _planes(N_MAIN)
    for s in _shifts(N_MAIN):
        got = _group(p)["main"][(h, s)]
        assert np.array_equal(got["x"], torch.roll(torch.as_tensor(x), s, 0).numpy()), (h, s)
        assert np.array_equal(got["v"], torch.roll(torch.as_tensor(v), s, 0).numpy()), (h, s)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("h", HS)
def test_shard_roll_equals_jax_shard_roll(p, h):
    x, v, _, _ = _planes(N_MAIN)
    roll = _jax_roll(p, h)
    for s in _shifts(N_MAIN):
        got = _group(p)["main"][(h, s)]
        ja, jb = roll(jnp.asarray(x.view(np.uint32)), jnp.asarray(v.astype(np.int32)), jnp.int32(s))
        assert np.array_equal(got["x"].view(np.uint32), np.asarray(ja)), (h, s)
        assert np.array_equal(got["v"], np.asarray(jb).astype(np.int64)), (h, s)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("h", HS)
def test_pipelined_equals_sequential_and_jax(p, h):
    x, v, learned, ride = _planes(N_MAIN)
    pipe = _jax_pipelined(p, h)
    for s in _shifts(N_MAIN):
        got = _group(p)["main"][(h, s)]
        rolled = np.roll(x, s, axis=0)
        assert np.array_equal(got["pipelined_x"], rolled), (h, s)
        assert np.array_equal(got["resp"], np.roll((learned | rolled) & ride, -s, axis=0)), (h, s)
        u32 = lambda a: jnp.asarray(a.view(np.uint32))  # noqa: E731
        ja, _, jresp = pipe(u32(x), jnp.asarray(v.astype(np.int32)), u32(learned), u32(ride), jnp.int32(s))
        assert np.array_equal(got["pipelined_x"].view(np.uint32), np.asarray(ja)), (h, s)
        assert np.array_equal(got["resp"].view(np.uint32), np.asarray(jresp)), (h, s)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("h", HS)
def test_send_count_is_h_plus_one_per_leg(p, h):
    """Each leg posts the plan's non-local sends for each rolled leaf (two
    leaves in ``shard_roll``'s case, one a leg in the pipelined pair), at
    most H + 1; the worst shift class reaches H + 1 at 4 ranks."""
    worst = 0
    for s in _shifts(N_MAIN):
        got = _group(p)["main"][(h, s)]
        want = _plan_sends(N_MAIN, p, h, s)
        want_back = _plan_sends(N_MAIN, p, h, N_MAIN - s % N_MAIN)
        assert got["sends"] == [2 * want], (h, s)
        assert got["pipelined_sends"] == [want, want_back], (h, s)
        assert want <= h + 1 and want_back <= h + 1
        worst = max(worst, want)
    if p == 4:
        assert worst == h + 1


@pytest.mark.parametrize("p", [2, 4])
def test_h_fallback_when_not_dividing(p):
    """Blocks of 10 rows do not split into H = 4 sub-blocks: the legs fall
    back to H = 1 (at most 2 sends a leaf a leg) and still equal
    ``torch.roll`` and the JAX package's legs."""
    n = 10 * p
    x, v, _, _ = _planes(n)
    roll = _jax_roll(p, 4)
    worst = 0
    for s in _shifts(n):
        got = _group(p)["fallback"][(4, s)]
        assert np.array_equal(got["x"], np.roll(x, s, axis=0)), s
        assert np.array_equal(got["v"], np.roll(v, s, axis=0)), s
        ja, _ = roll(jnp.asarray(x.view(np.uint32)), jnp.asarray(v.astype(np.int32)), jnp.int32(s))
        assert np.array_equal(got["x"].view(np.uint32), np.asarray(ja)), s
        assert got["sends"] == [2 * _plan_sends(n, p, 4, s)], s
        worst = max(worst, got["sends"][0] // 2)
    assert worst <= 2
