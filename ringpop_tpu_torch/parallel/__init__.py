"""The port's transport and sharding plane (counterpart of
``ringpop_tpu/parallel``): ``fabric`` (the RPC and codec half), and the
meshes over ``torch.distributed`` ranks — ``partition`` (the per-leaf rule
table, placement, the fleet's batch-axis placement, digest partials),
``mesh`` (the (node, rumor) mesh and the fleet's (batch, node, rumor) one),
``shift`` (the exchange's roll legs) and ``multihost`` (process-group
bring-up).

This package imports nothing: ``parallel.fabric`` is numpy-only, and the
serve tier's frontend processes reach it through ``net/channel.py`` and
``serve/shm.py`` without starting a device runtime, so the modules that
import torch load only when named."""
