"""The serve tier (counterpart of ``ringpop_tpu/serve``): frontend processes
send key-hash batches over shared memory or TCP to one device-resident ring;
a micro-batching collector coalesces them into padded dispatches and answers
each request with the generation the device used.

* :mod:`.state` — ``DeviceRing``, ``ring_commit``, ``RingStore``;
* :mod:`.service` — ``RingService``, the collector, and its telemetry;
* :mod:`.shm` and :mod:`.client` — the frontend halves (torch-free);
* :mod:`.bench` — ``run_ab``, the paired serve-vs-bisect A/B;
* :mod:`.placement` — the DGRO token-placement pass, opt-in behind the
  default random replica placement;
* :mod:`.mesh` — the P-rank serve mesh: each rank owns a ring block and
  cross-forwards mis-routed keys over the fabric.

This package file imports nothing, so a frontend process that imports
``serve.shm`` or ``serve.client`` loads no torch."""
