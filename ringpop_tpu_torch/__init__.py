"""ringpop_tpu_torch: the PyTorch / CUDA port of ringpop_tpu's device plane.

It mirrors ``ringpop_tpu``'s module paths and imports neither JAX nor any
module of ``ringpop_tpu``: where it needs a host module of that package, it
keeps its own copy.  Hash values and ring tokens are int64 tensors holding
the uint32 value.  State-creating entry points default to the CUDA card
(``device.resolve_device``); ops on given tensors follow those tensors'
device — the plain PyTorch version on the CPU, the hand-written Hopper
kernel on the card.

Ported so far: the keyed-ownership path — ``hashing`` (numpy farm copy),
``hashring``, ``events``, ``ops.hash_ops`` / ``ops.hash_kernel`` (the
Fingerprint32 kernel, ``csrc/fingerprint32.cu``), ``ops.ring_ops`` and
``serve.state``; the sim plane — ``sim.packbits`` / ``ops.packbits_kernel``
(``csrc/packbits.cu``), ``sim.prng``, ``sim.threefry`` /
``ops.threefry_kernel`` (``csrc/threefry.cu``), ``sim.delta`` and
``sim.lifecycle`` / ``ops.lifecycle_kernel`` (``csrc/lifecycle.cu``), with
``swim.member``'s key lattice, ``sim.fullview`` / ``ops.fullview_kernel``
(``csrc/fullview.cu``) and ``sim.conformance``, the exact engine and the
lockstep conformance gate; ``sim.telemetry`` / ``ops.telemetry_kernel``
(``csrc/telemetry.cu``), ``sim.chaos`` and ``sim.topology``, the run
journal and the time-varying fault plans, with ``options``' stats sinks
and ``obs.flight``'s commit read; ``sim.montecarlo``, ``sim.scenarios``
and ``sim.snapshot``, the scenario fleet; the serve tier's collector
``serve.service`` with its transports — ``net.channel``, the RPC and codec
half of ``parallel.fabric``, ``serve.shm``, ``serve.client`` (torch-free,
with ``errors``, ``logging``, ``util.metrics`` and ``obs.trace``) — and
``serve.bench``'s paired A/B ``run_ab``; the node, rumor and batch axes of
a mesh (``parallel.partition``, ``parallel.mesh``, ``parallel.shift``,
``parallel.multihost``); the multi-host delta ``sim.delta_multihost`` over
the exchange half of ``parallel.fabric``, with ``cli.multihost_bench`` and
``cli.multihost_launch``; the serve plane's ``serve.placement``,
``serve.mesh``, ``forward`` and ``obs``; the SWIM host stack — ``swim``'s
``Node`` and its parts, ``util.clock``, ``discovery``, ``options.Options``,
``sim.snapshot``'s membership export and import — and the facade over it,
``ringpop.Ringpop``, with ``router``, ``replica`` and ``adapter`` (every
one torch-free but ``sim.snapshot``); the host plane's process entry
points — ``cli.testpop`` (a standalone node), ``cli.admin`` and
``cli.stats`` (the operator and stats clients) and ``harness`` (clusters of
testpop processes), all torch-free; the warm start — ``util.accel`` (the
probe and the kernels' fingerprinted build cache) and ``util.aot`` (the
load-or-compile front door behind the engines' ``aot=``) — and
``cli.fleet_bench``, one rank of a scenario-fleet run; ``bench``, the
twin of the repository's ``bench.py`` (``python -m ringpop_tpu_torch.bench``);
and ``cli.simbench``, the twin of the scenario suite (``python -m
ringpop_tpu_torch.cli.simbench``).
"""

from ringpop_tpu_torch.version import __version__

__all__ = ["__version__"]
