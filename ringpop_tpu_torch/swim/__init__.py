"""The SWIM membership protocol of the port, host plane and shared core.

Counterpart of ``ringpop_tpu/swim`` (reference ``swim/``): :mod:`member`'s
state ids, override predicates and packed keys (what the lifecycle engine
reads on tensors) and the host plane's ``Member`` and ``Change``; the node
(:mod:`node`) and its parts — :mod:`memberlist`, :mod:`iter`,
:mod:`disseminator`, :mod:`state_transitions`, :mod:`gossip`, :mod:`ping`,
:mod:`ping_request`, :mod:`join`, :mod:`heal`, :mod:`handlers`,
:mod:`rollup`, :mod:`events` and :mod:`stats` — copied from the JAX
package, their random streams and coroutine order unchanged, so a cluster's
history is the JAX package's.  None of them imports torch.
"""

from ringpop_tpu_torch.swim.member import (
    Member,
    Change,
    ALIVE,
    SUSPECT,
    FAULTY,
    LEAVE,
    TOMBSTONE,
    state_precedence,
    non_local_override,
    local_override,
    overrides,
)


def __getattr__(name):
    # lazy: node pulls the whole host plane; the semantics core stays light
    if name in ("Node", "NodeOptions", "BootstrapOptions"):
        from ringpop_tpu_torch.swim import node as _node

        return getattr(_node, name)
    if name == "StateTimeouts":
        from ringpop_tpu_torch.swim.state_transitions import StateTimeouts

        return StateTimeouts
    raise AttributeError(name)


__all__ = [
    "Member",
    "Change",
    "ALIVE",
    "SUSPECT",
    "FAULTY",
    "LEAVE",
    "TOMBSTONE",
    "state_precedence",
    "non_local_override",
    "local_override",
    "overrides",
    "Node",
    "NodeOptions",
    "BootstrapOptions",
    "StateTimeouts",
]
