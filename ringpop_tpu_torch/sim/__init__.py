"""The sim plane of the port: whole simulated SWIM clusters as dense tensors.

Counterpart of ``ringpop_tpu/sim``.  Ported so far:

* :mod:`ringpop_tpu_torch.sim.packbits` — bit-packed boolean planes (the
  K rumor slots 32 to an int32 word) and their word ops; the popcount and
  the bitwise OR/AND row reduces launch the hand-written Hopper kernels of
  ``csrc/packbits.cu`` on a CUDA tensor;
* :mod:`ringpop_tpu_torch.sim.prng` — the partition-invariant counter
  stream (``rng="counter"``), a pure function of (seed, tick, site, lane);
* :mod:`ringpop_tpu_torch.sim.threefry` — the ``jax.random`` threefry
  stream (``rng="threefry"``, the engines' default): split, randint,
  uniform and raw bits, one launch of the Hopper kernel of
  ``csrc/threefry.cu`` a draw on a CUDA key;
* :mod:`ringpop_tpu_torch.sim.delta` — the O(N·K) rumor-dissemination
  engine (``DeltaSim``) at either stream;
* :mod:`ringpop_tpu_torch.sim.lifecycle` — the O(N·K) failure-detection
  engine (``LifecycleSim``: probe, ping-req, Suspect, Faulty, Tombstone,
  evict, refutation) at either stream; its slot walk and
  first-live-learner select launch the Hopper kernels of
  ``csrc/lifecycle.cu`` on a CUDA tensor.

This module imports none of them, so importing the package costs nothing.
"""
