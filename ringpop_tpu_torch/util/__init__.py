"""Host utilities of the port (counterpart of ``ringpop_tpu/util``, parity:
reference ``util/util.go``): hostport parsing and validation, shuffles,
zero-means-default option selection, millisecond time helpers and the
integer-Unix ``Timestamp`` JSON codec, beside ``metrics``' ``Histogram`` and
``Meter`` and ``clock``'s timers.  Torch-free.
"""

from __future__ import annotations

import random
import re
import time as _time
from typing import Iterable, Optional, Sequence, TypeVar

T = TypeVar("T")

_HOSTPORT_RE = re.compile(r"^(\d+\.\d+\.\d+\.\d+):\d+$")
_HOSTPORT_PATTERN = re.compile(r"^([^:]+):\d+$")


def capture_host(hostport: str) -> str:
    """Extract the host part of a ``host:port`` string; empty string when the
    input does not parse (parity: reference ``util/util.go:37-46`` CaptureHost).
    """
    m = _HOSTPORT_PATTERN.match(hostport)
    return m.group(1) if m else ""


def is_valid_hostport(hostport: str) -> bool:
    """True when the string looks like ``ip:port`` (reference validation used
    by identity checks, ``util/util.go``)."""
    return bool(_HOSTPORT_PATTERN.match(hostport))


def host_ports_by_host(host_ports: Iterable[str]) -> dict[str, list[str]]:
    """Group a list of hostports per host (parity: ``util/util.go``
    HostPortsByHost)."""
    out: dict[str, list[str]] = {}
    for hp in host_ports:
        host = capture_host(hp)
        if host:
            out.setdefault(host, []).append(hp)
    return out


def check_hostname_ip_mismatch(local: str, host_ports: Iterable[str]) -> Optional[str]:
    """Warn-condition check: mixing hostnames and IPs in a bootstrap list is a
    common misconfiguration (parity: ``util/util.go:48-85``).  Returns a
    warning message or None."""

    def is_ip(hp: str) -> bool:
        return bool(_HOSTPORT_RE.match(hp))

    local_is_ip = is_ip(local)
    mismatched = [hp for hp in host_ports if is_ip(hp) != local_is_ip]
    if not mismatched:
        return None
    kind = "hostname" if local_is_ip else "IP"
    return (
        f"local identity {local!r} mixes with {kind} entries in the bootstrap "
        f"list ({mismatched[:3]}...); all hosts should use the same form"
    )


def single_node_cluster(local: str, host_ports: Sequence[str]) -> bool:
    """True when the bootstrap list designates a single-node cluster: the only
    host is the local node itself (parity: ``util/util.go:120-128``)."""
    return len(host_ports) == 1 and host_ports[0] == local


def shuffle_strings(strings: Sequence[str], rng: Optional[random.Random] = None) -> list[str]:
    """Return a new pseudo-randomly shuffled list (parity: ``util/util.go``
    ShuffleStrings)."""
    out = list(strings)
    (rng or random).shuffle(out)
    return out


def take_node(
    nodes: list[str], index: int = -1, rng: Optional[random.Random] = None
) -> Optional[str]:
    """Remove and return a node from the list: at ``index`` when >= 0, at a
    random position otherwise (parity: ``util/util.go`` TakeNode)."""
    if not nodes:
        return None
    if index < 0:
        index = (rng or random).randrange(len(nodes))
    if index >= len(nodes):
        return None
    return nodes.pop(index)


def select_int(opt: int, default: int) -> int:
    """Zero-means-default option merge (parity: ``util/util.go:222-245``
    SelectInt)."""
    return default if opt == 0 else opt


def select_float(opt: float, default: float) -> float:
    return default if opt == 0 else opt


def select_duration(opt: float, default: float) -> float:
    """Durations are seconds (float) on this side; 0 selects the default."""
    return default if opt == 0 else opt


def ms_to_s(ms: int) -> float:
    return ms / 1000.0


def s_to_ms(s: float) -> int:
    return int(s * 1000)


def now_ms(clock=None) -> int:
    """Current wall time in milliseconds; the unit used for incarnation
    numbers (parity: ``swim/memberlist.go`` nowInMillis)."""
    if clock is not None:
        return s_to_ms(clock.now())
    return s_to_ms(_time.time())


class Timestamp(int):
    """Timestamp encoded as integer Unix *seconds* in JSON (parity:
    ``util/util.go:257-277``).  It is an ``int`` subtype so it JSON-encodes
    naturally."""

    @classmethod
    def now(cls, clock=None) -> "Timestamp":
        t = clock.now() if clock is not None else _time.time()
        return cls(int(t))
