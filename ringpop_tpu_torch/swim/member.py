"""SWIM member states, override predicates and packed override keys.

Counterpart of the pure-function half of ``ringpop_tpu/swim/member.py``
(reference ``swim/member.go``): the five states in precedence order, the
override comparisons, and the packed key ``(incarnation << 3) | state``
whose integer order is the override order, so the sim engines take lattice
maxes over it.  Every function uses only ``>``, ``>=``, ``&``, ``|``,
``==``, ``<<`` and ``>>``, so it works elementwise on Python ints, numpy
arrays and int32 tensors alike.  On int32, ``pack_key`` wraps for
incarnations at or above 2**28 and ``key_incarnation`` shifts
arithmetically, exactly as the JAX package's int32 arrays do.
"""

from __future__ import annotations

# Member states, ordered by precedence (reference member.go:30-45,112-128).
ALIVE = 0
SUSPECT = 1
FAULTY = 2
LEAVE = 3
TOMBSTONE = 4

STATE_NAMES = ("alive", "suspect", "faulty", "leave", "tombstone")
STATE_IDS = {name: i for i, name in enumerate(STATE_NAMES)}

# unknown wire states never take precedence (member.go:124-127)
UNKNOWN = -1


def state_name(state: int) -> str:
    return STATE_NAMES[state] if 0 <= state < len(STATE_NAMES) else "unknown"


def state_id(name: str) -> int:
    return STATE_IDS.get(name, UNKNOWN)


def overrides(inc_a, state_a, inc_b, state_b):
    """True when change A = (inc_a, state_a) strictly overrides B in the
    (incarnation, precedence) lexicographic order (member.go:79-93,
    178-187)."""
    return (inc_a > inc_b) | ((inc_a == inc_b) & (state_a > state_b))


non_local_override = overrides


def is_detraction(state):
    """Suspect, Faulty and Tombstone claims are the ones a live subject
    refutes (the predicate inside member.go:98-110)."""
    return (state == SUSPECT) | (state == FAULTY) | (state == TOMBSTONE)


def local_override(inc_change, state_change, inc_local):
    """True when a change about the local node must be refuted by
    reincarnation: a detraction at an incarnation >= ours
    (member.go:98-110)."""
    return is_detraction(state_change) & (inc_change >= inc_local)


def is_reachable(state):
    """Alive and Suspect members count for the ring and are pinged
    (member.go:130-132, 189-191)."""
    return (state == ALIVE) | (state == SUSPECT)


is_pingable = is_reachable


# -- packed override keys: 5 states in 3 bits, incarnations in the rest ------

KEY_STATE_BITS = 3


def pack_key(incarnation, state):
    """Order embedding of :func:`overrides`: pack_key(a) > pack_key(b) iff
    change a overrides b (for incarnations below 2**28)."""
    return (incarnation << KEY_STATE_BITS) | state


def key_state(key):
    return key & ((1 << KEY_STATE_BITS) - 1)


def key_incarnation(key):
    return key >> KEY_STATE_BITS
