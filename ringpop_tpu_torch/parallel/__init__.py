"""The port's transport and sharding plane (counterpart of
``ringpop_tpu/parallel``).  So far only ``fabric``'s RPC and codec half.

This package imports nothing: ``parallel.fabric`` is numpy-only, and the
serve tier's frontend processes reach it through ``net/channel.py`` and
``serve/shm.py`` without starting a device runtime, so the modules that
will import torch here (ROADMAP A12) stay out of this file."""
