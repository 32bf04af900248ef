"""The SWIM membership core of the port.

Counterpart of ``ringpop_tpu/swim``.  Ported so far: :mod:`member`'s state
ids, override predicates and packed override keys — what the lifecycle
engine (``sim/lifecycle.py``) reads.  The host plane (``Member``,
``Change``, the node and its transports) is not ported yet.
"""
