"""Shard-local exchange legs for the ``exchange="shift"`` topology.

Counterpart of ``ringpop_tpu/parallel/shift.py``, written as
``torch.distributed`` point-to-point sends (``Mesh.exchange``, one
``batch_isend_irecv`` a leg) between node ranks that each hold an
``nb``-row block.  A leg rolls a node-sharded plane cyclically:
``out[i] = x[(i - s) mod n]``.  On a (P, R) mesh a leg runs over the node
axis of this rank's rumor column: each of the R word blocks rolls on its
own, between the P ranks that hold it, by the same shift.

The decomposition is the JAX package's.  Split each rank's block into
``H`` equal sub-blocks of ``sub = nb/H`` rows and write ``s = hq·sub +
rh``.  Every destination rank's output window then covers exactly ``H+1``
consecutive sub-blocks of the input ring, so a leg is ``H+1`` sends per
rolled leaf — sends whose ring offset is 0 are local and skipped — and
one slice at ``sub - rh`` stitches each output sub-block from two window
pieces.  ``hq`` and ``rh`` are read on the host (one sync a tick: the
shift is drawn on the device), and pick the static send plan.  ``H``
falls back to 1 when it does not divide the block.  Shifts outside
``[0, n)`` follow ``torch.roll``'s mod-n contract.

:func:`shard_roll_pipelined` runs a tick's two legs, the JAX package's
fused region, as its two :func:`shard_roll` calls: the request leg rolls
forward by ``s``; the response plane, an elementwise function of the
rolled planes and of carried planes, rolls back by ``n - s``.

The region is pure data movement, so it equals ``torch.roll`` bit for bit.
``leg_sends`` holds the sends each leg posted since :func:`reset_stats`
(the JAX package pins these counts in its traced program; here they are
counted where they are posted); the mesh's ``stats`` count their bytes.
"""

from __future__ import annotations

import torch

DEFAULT_H = 2

leg_sends: list[int] = []


def reset_stats() -> None:
    leg_sends.clear()


def _layout(leaves: tuple, mesh, axis: str, h: int):
    """(n, nb, h_eff, sub): ``h`` falls back to 1 when it does not divide
    the block."""
    s_shards = mesh.shape[axis]
    if s_shards <= 1:
        raise ValueError("shard_roll needs >1 node shard; use the gather path")
    if h < 1:
        raise ValueError(f"sub-block factor h={h} must be >= 1")
    nb = leaves[0].shape[0]
    if any(x.shape[0] != nb for x in leaves):
        raise ValueError("every rolled leaf must hold the same block of rows")
    h_eff = h if nb % h == 0 else 1
    return nb * s_shards, nb, h_eff, nb // h_eff


def _check_specs(specs, axis: str) -> None:
    for spec in specs or ():
        if spec is not None and len(spec) and spec[0] != axis:
            raise ValueError(f"a rolled leaf must shard its axis 0 over {axis!r}, got {spec}")


def _window_plan(hqi: int, h: int, s_shards: int) -> list:
    """Static send plan for one quotient class: window part p (of H+1) for
    destination d is global sub-block H·d - m with m = hqi + 1 - p: it
    lives on the rank ceil(m/H) ring-steps back, at local sub-index
    (-m) mod H."""
    plan = []
    for p in range(h + 1):
        m = hqi + 1 - p
        ring = -(-m // h) % s_shards  # ceil(m/H) mod S
        plan.append((ring, (-m) % h))
    return plan


def _issue(plan: list, pieces_of, mesh) -> list:
    """One leg: for each plan entry, every leaf's source piece
    (``pieces_of(si)``, a list), sent to the rank ``ring`` steps on and
    received from the rank ``ring`` steps back; local where ring is 0.
    Returns ``recv[p][leaf]``."""
    s_shards, me = mesh.shape["node"], mesh.coords["node"]
    sends, recvs, slots = [], [], []
    recv = []
    for p, (ring, si) in enumerate(plan):
        pieces = pieces_of(si)
        if ring:
            for li, piece in enumerate(pieces):
                tag = p * len(pieces) + li
                sends.append((piece, (me + ring) % s_shards, tag))
                recvs.append((piece, (me - ring) % s_shards, tag))
                slots.append((p, li))
        recv.append(list(pieces))
    got = mesh.exchange(sends, recvs, "node")
    for (p, li), t in zip(slots, got):
        recv[p][li] = t
    leg_sends.append(len(sends))
    return recv


def _stitch_sub(recv: list, leaf: int, d: int, rh: int, sub: int) -> torch.Tensor:
    """Destination sub-block ``d`` of one rolled leaf: window pieces d and
    d+1 at offset ``sub - rh`` (rh == 0: piece d+1 whole)."""
    if rh == 0:
        return recv[d + 1][leaf]
    return torch.cat([recv[d][leaf][sub - rh:], recv[d + 1][leaf][:sub - rh]], dim=0)


def _split(shift, n: int, sub: int) -> tuple[int, int, int]:
    s = int(shift) % n
    hq = s // sub
    return s, hq, s - hq * sub


def shard_roll(leaves: tuple, shift, mesh, axis: str = "node", specs=None, h: int = DEFAULT_H) -> tuple:
    """``torch.roll(x, shift, dims=0)`` of the global leaf, for every leaf
    of ``leaves`` given as this rank's block (one shared block size; n =
    block × ranks).  ``shift``: an int or a 0-d tensor, taken mod n.
    ``specs``: optional specs whose axis 0 must be ``axis``.  ``h``:
    sub-blocks a block (falls back to 1 when it does not divide it).
    Every rank calls it with the same shift and leaf shapes.  Needs more
    than one node rank."""
    _check_specs(specs, axis)
    n, nb, h, sub = _layout(leaves, mesh, axis, h)
    _, hq, rh = _split(shift, n, sub)
    subs = [x.reshape((h, sub) + tuple(x.shape[1:])) for x in leaves]
    recv = _issue(_window_plan(hq, h, mesh.shape["node"]), lambda si: [sx[si] for sx in subs], mesh)
    return tuple(torch.cat([_stitch_sub(recv, li, d, rh, sub) for d in range(h)], dim=0)
                 for li in range(len(leaves)))


def shard_roll_pipelined(leg1: tuple, shift, mesh, axis: str = "node", specs1=None, carry: tuple = (),
                         carry_specs=None, leg2_of=None, spec2=None, h: int = DEFAULT_H) -> tuple:
    """Both exchange legs of one tick.  Leg 1 rolls every leaf of ``leg1``
    forward by ``shift`` (mod n); the response plane ``leg2_of(*leg1_rolled,
    *carry)`` — elementwise along axis 0 — rolls back by ``n - shift``.
    Returns ``(*leg1_rolled, leg2_rolled)``: the two :func:`shard_roll`
    calls, as the JAX package's region is bit for bit.  ``Mesh.exchange``
    waits for a leg's every transfer before it returns, so the port has no
    overlap between legs to build the response plane early for."""
    _check_specs(specs1, axis)
    _check_specs(carry_specs, axis)
    _check_specs((spec2,), axis)
    n = _layout(tuple(leg1) + tuple(carry), mesh, axis, h)[0]
    s = int(shift) % n  # one host read of a device shift
    outs = shard_roll(tuple(leg1), s, mesh, axis, h=h)
    (back,) = shard_roll((leg2_of(*outs, *carry),), n - s, mesh, axis, h=h)
    return outs + (back,)
