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
  uniform, raw bits, fold_in and the masked categorical draw, one launch
  of a Hopper kernel of ``csrc/threefry.cu`` a draw on a CUDA key;
* :mod:`ringpop_tpu_torch.sim.delta` — the O(N·K) rumor-dissemination
  engine (``DeltaSim``) at either stream;
* :mod:`ringpop_tpu_torch.sim.lifecycle` — the O(N·K) failure-detection
  engine (``LifecycleSim``: probe, ping-req, Suspect, Faulty, Tombstone,
  evict, refutation) at either stream; its slot walk and
  first-live-learner select launch the Hopper kernels of
  ``csrc/lifecycle.cu`` on a CUDA tensor;
* :mod:`ringpop_tpu_torch.sim.fullview` — the exact full-view engine
  (``FullViewSim``: the whole cluster as [N, N] planes, every node's view
  of every member); each change application is the Hopper kernel of
  ``csrc/fullview.cu`` and the ping-target and ping-req peer draws the
  masked categorical kernel of ``csrc/threefry.cu`` on the card;
* :mod:`ringpop_tpu_torch.sim.conformance` — the lockstep conformance
  gate: ``SequentialSwim``, a change-at-a-time interpreter of the SWIM
  rules, and ``LockstepRunner``, which drives it and ``FullViewSim``
  through the same injected draws and demands bit-identical state;
* :mod:`ringpop_tpu_torch.sim.telemetry` — the telemetry plane: per-tick
  counter accumulators (one launch of the Hopper kernel P1 a tick on the
  card), the block fetch and census, the state digest (kernel D1), the
  JSONL run journal, the stats bridge and ``TelemetrySink``;
* :mod:`ringpop_tpu_torch.sim.chaos` — time-varying fault plans
  (``FaultPlan``, evaluated on the card at the state's tick), their
  builders and batching, and the convergence scorer ``score_blocks``;
* :mod:`ringpop_tpu_torch.sim.topology` — rack/zone/region trees compiled
  to tier legs and correlated-failure plans;
* :mod:`ringpop_tpu_torch.sim.montecarlo` — the Monte-Carlo fleet
  (``MonteCarlo``): B lockstep replicas differing in seed and fault
  scenario, each stepped through the solo lifecycle tick and read as one
  batched state, whole or block-sharded over a fleet mesh; the
  detection-latency studies;
* :mod:`ringpop_tpu_torch.sim.scenarios` — the scenario-grid compiler,
  the scored and resumable fleet sweep (``FleetSweep``, process-sliced or
  on a fleet mesh), response surfaces and the adaptive cliff search;
* :mod:`ringpop_tpu_torch.sim.snapshot` — engine snapshots in the JAX
  package's ``.npz`` format (either package loads the other's), the
  fleet's npz carry, and the multi-process checkpoint store;
* :mod:`ringpop_tpu_torch.sim.delta_multihost` — the delta engine across
  OS processes (``MultihostDelta``): each steps its node block and ships
  the window legs and reduce words over ``parallel.fabric``'s TCP mesh.

This module imports none of them, so importing the package costs nothing.
"""
