"""The port's transport and sharding plane (counterpart of
``ringpop_tpu/parallel``): ``fabric`` (the RPC and codec half), and the node
mesh over ``torch.distributed`` ranks — ``partition`` (the per-leaf rule
table, placement, digest partials), ``mesh``, ``shift`` (the exchange's
roll legs) and ``multihost`` (process-group bring-up).

This package imports nothing: ``parallel.fabric`` is numpy-only, and the
serve tier's frontend processes reach it through ``net/channel.py`` and
``serve/shm.py`` without starting a device runtime, so the modules that
import torch load only when named."""
