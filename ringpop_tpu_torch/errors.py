"""Sentinel errors (parity: reference ``errors.go:27-35``)."""


class RingpopError(Exception):
    pass


class NotBootstrappedError(RingpopError):
    """(parity: ErrNotBootstrapped)"""

    def __str__(self) -> str:
        return "ringpop is not bootstrapped"


class EphemeralIdentityError(RingpopError):
    """(parity: ErrEphemeralIdentity) — port 0 identities cannot be gossiped."""

    def __str__(self) -> str:
        return "cannot get ringpop identity from ephemeral port"


class InvalidStateError(RingpopError):
    pass


# -- the unified transport error family (r17) ---------------------------------
#
# One peer-lifecycle/error model for every transport — the DCN fabric,
# the serve TCP framing, the shm ring.  Defined HERE (an import-free
# leaf) so the torch-free surfaces (net/channel.py, serve/shm.py — what
# frontend processes import without paying a device runtime's start) can
# share the family with parallel/fabric.py, which re-exports them under
# the JAX package's import path.


class FabricError(RuntimeError):
    """Any fabric-layer (or unified-transport) failure with peer
    context attached."""


class FabricPeerLost(FabricError):
    """A peer's socket closed mid-run — the peer process died (or shut
    its transport down) while this side still expected messages from
    it.  Channel flavor: connect refused / connection dropped."""


class FabricTimeout(FabricError):
    """A live but SILENT peer: nothing arrived (or a send could not
    drain) within the deadline.  Distinct from a tag desync — the
    schedule may still agree; the peer is wedged or partitioned."""


class FabricDesync(FabricError):
    """A message arrived with the WRONG tag: the peers' deterministic
    schedules disagree (a leg skipped or reordered).  Both endpoints
    are alive — that is what distinguishes this from the two above."""
