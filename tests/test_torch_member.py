"""The port's SWIM key lattice against the JAX package's.

``ringpop_tpu_torch.swim.member`` keeps its own copy of the state ids, the
override predicates and the packed override keys of
``ringpop_tpu.swim.member``.  Here every function equals the JAX package's
on Python-int grids (negative states and incarnations included) and on int32
tensors against int32 numpy arrays, incarnations near 2**28, where
``pack_key`` wraps in int32.
"""

import itertools

import numpy as np
import pytest
import torch

from ringpop_tpu.swim import member as jm

from ringpop_tpu_torch.swim import member as tm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STATES = range(-1, 6)
INCS = (-3, -1, 0, 1, 2, 7, 2**27, 2**28 - 1, 2**28, 2**28 + 5)


def test_constants_match():
    for name in ("ALIVE", "SUSPECT", "FAULTY", "LEAVE", "TOMBSTONE", "UNKNOWN", "KEY_STATE_BITS",
                 "STATE_NAMES", "STATE_IDS"):
        assert getattr(tm, name) == getattr(jm, name), name
    for s in STATES:
        assert tm.state_name(s) == jm.state_name(s)
    for name in (*jm.STATE_NAMES, "bogus"):
        assert tm.state_id(name) == jm.state_id(name)


@pytest.mark.parametrize("fn", ["is_detraction", "is_reachable", "is_pingable"])
def test_state_predicates_on_ints(fn):
    for s in STATES:
        assert getattr(tm, fn)(s) == getattr(jm, fn)(s), (fn, s)


def test_overrides_and_local_override_on_ints():
    for ia, sa, ib, sb in itertools.product((-1, 0, 1, 5), range(0, 5), (-1, 0, 1, 5), range(0, 5)):
        assert tm.overrides(ia, sa, ib, sb) == jm.overrides(ia, sa, ib, sb)
        assert tm.non_local_override(ia, sa, ib, sb) == jm.non_local_override(ia, sa, ib, sb)
        assert tm.local_override(ia, sa, ib) == jm.local_override(ia, sa, ib)


def test_pack_key_round_trip_on_ints():
    for inc, s in itertools.product(INCS, range(0, 5)):
        key = tm.pack_key(inc, s)
        assert key == jm.pack_key(inc, s)
        assert tm.key_state(key) == jm.key_state(key) == s
        assert tm.key_incarnation(key) == jm.key_incarnation(key) == inc


def _grid():
    inc = np.array([i for i in INCS for _ in range(5)], np.int32)
    st = np.array(list(range(5)) * len(INCS), np.int32)
    return inc, st


def test_key_lattice_on_int32_tensors_matches_int32_arrays():
    """On int32, ``inc << 3`` wraps at 2**28 in both packages (the numpy
    arrays stand for the JAX package's int32 arrays), and the key's
    incarnation shifts arithmetically: negative keys stay negative."""
    inc, st = _grid()
    want = jm.pack_key(inc, st)
    assert want.dtype == np.int32
    got = tm.pack_key(torch.from_numpy(inc), torch.from_numpy(st))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want < 0).any(), "the grid reaches the int32 wrap"
    for fn in ("key_state", "key_incarnation"):
        assert np.array_equal(getattr(tm, fn)(got).numpy(), getattr(jm, fn)(want)), fn
    keys = np.array([-(2**31), -9, -8, -1, 0, 7, 8, 2**31 - 1], np.int32)
    for fn in ("key_state", "key_incarnation"):
        assert np.array_equal(getattr(tm, fn)(torch.from_numpy(keys)).numpy(), getattr(jm, fn)(keys)), fn


def test_predicates_on_int32_tensors():
    rng = np.random.default_rng(4)
    sa, sb = (rng.integers(-1, 6, 500).astype(np.int32) for _ in range(2))
    ia, ib = (rng.integers(-3, 4, 500).astype(np.int32) for _ in range(2))
    ta, tb, tia, tib = (torch.from_numpy(x) for x in (sa, sb, ia, ib))
    for fn in ("is_detraction", "is_reachable", "is_pingable"):
        assert np.array_equal(getattr(tm, fn)(ta).numpy(), getattr(jm, fn)(sa)), fn
    assert np.array_equal(tm.overrides(tia, ta, tib, tb).numpy(), jm.overrides(ia, sa, ib, sb))
    assert np.array_equal(tm.local_override(tia, ta, tib).numpy(), jm.local_override(ia, sa, ib))
    # int8 states, as the engines keep them
    assert np.array_equal(tm.is_pingable(ta.to(torch.int8)).numpy(), jm.is_pingable(sa.astype(np.int8)))
