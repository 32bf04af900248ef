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
``swim.member``'s key lattice; and ``bench``, the twin of the repository's
``bench.py`` (``python -m ringpop_tpu_torch.bench``).
"""
