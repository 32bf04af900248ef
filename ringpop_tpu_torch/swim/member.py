"""SWIM member states, override predicates, packed override keys, and the
host plane's ``Member`` and ``Change``.

Counterpart of ``ringpop_tpu/swim/member.py`` (reference ``swim/member.go``):
the five states in precedence order, the override comparisons, and the
packed key ``(incarnation << 3) | state`` whose integer order is the
override order, so the sim engines take lattice maxes over it; and the host
plane's member and change records with the wire codec (the reference's JSON
tags and tombstone shims, ``member.go:150-167``).  Every predicate uses only
``>``, ``>=``, ``&``, ``|``, ``==``, ``<<`` and ``>>``, so it works
elementwise on Python ints, numpy arrays and int32 tensors alike.  On int32, ``pack_key`` wraps for
incarnations at or above 2**28 and ``key_incarnation`` shifts
arithmetically, exactly as the JAX package's int32 arrays do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

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


def state_precedence(state):
    """Identity by construction: the int encoding is the precedence order
    (parity: ``member.go:112-128`` statePrecedence)."""
    return state


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


@dataclass
class Member:
    """A member of the cluster as seen by one node
    (parity: ``member.go:48-53``)."""

    address: str
    status: int = ALIVE
    incarnation: int = 0

    @property
    def is_reachable(self) -> bool:
        return bool(is_reachable(self.status))

    @property
    def is_pingable(self) -> bool:
        return bool(is_pingable(self.status))

    def non_local_override(self, change: "Change") -> bool:
        return bool(non_local_override(change.incarnation, change.status, self.incarnation, self.status))

    def local_override(self, local_address: str, change: "Change") -> bool:
        if self.address != local_address:
            return False
        return bool(local_override(change.incarnation, change.status, self.incarnation))


@dataclass
class Change:
    """A membership change to disseminate (parity: ``member.go:135-145``).

    ``status`` is an int state here; the wire codec maps to the reference's
    string states and applies the tombstone back-compat shim."""

    address: str
    incarnation: int
    status: int
    source: str = ""
    source_incarnation: int = 0
    timestamp: int = 0  # integer Unix seconds (util.Timestamp codec)
    # original wire string for states we don't recognize: the reference keeps
    # unknown status strings verbatim (they decode to precedence -1 but
    # re-serialize unchanged); without this, an int-encoded UNKNOWN would
    # corrupt into a different state on re-send
    raw_status: str = ""

    def overrides(self, other: "Change") -> bool:
        return bool(
            overrides(self.incarnation, self.status, other.incarnation, other.status)
        )

    @property
    def is_pingable(self) -> bool:
        return bool(is_pingable(self.status))

    # -- wire codec (parity: member.go JSON tags + :150-167 shims) ----------

    def to_wire(self) -> dict:
        """Serialize with reference-compatible JSON keys; Tombstone is sent as
        Faulty+tombstone flag for old peers (parity: ``member.go:159-167``
        validateOutgoing)."""
        status = self.status
        d: dict[str, Any] = {
            "source": self.source,
            "sourceIncarnationNumber": self.source_incarnation,
            "address": self.address,
            "incarnationNumber": self.incarnation,
            "timestamp": int(self.timestamp),
        }
        if status == TOMBSTONE:
            d["status"] = STATE_NAMES[FAULTY]
            d["tombstone"] = True
        elif status == UNKNOWN:
            d["status"] = self.raw_status or "unknown"
        else:
            d["status"] = STATE_NAMES[status]
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "Change":
        """Parse with the incoming tombstone shim: Faulty+flag → Tombstone
        (parity: ``member.go:150-157`` validateIncoming)."""
        status = state_id(d["status"])
        if status == FAULTY and d.get("tombstone"):
            status = TOMBSTONE
        return cls(
            address=d["address"],
            incarnation=int(d["incarnationNumber"]),
            status=status,
            source=d.get("source", ""),
            source_incarnation=int(d.get("sourceIncarnationNumber", 0)),
            timestamp=int(d.get("timestamp", 0)),
            raw_status=d["status"] if status == UNKNOWN else "",
        )


def member_to_change(m: Member, source: str, source_inc: int, ts: int = 0) -> Change:
    """A full-membership entry sent on the wire (joins/full-syncs) is just a
    Change (parity: ``swim/disseminator.go:107-123`` MembershipAsChanges)."""
    return Change(
        address=m.address,
        incarnation=m.incarnation,
        status=m.status,
        source=source,
        source_incarnation=source_inc,
        timestamp=ts,
    )
