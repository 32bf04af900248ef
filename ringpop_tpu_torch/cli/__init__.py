"""Command-line entry points of the port (counterpart of ``ringpop_tpu/cli``):
``testpop``, a standalone node; ``admin`` and ``stats``, the operator and
stats clients (these three torch-free); ``multihost_bench`` and
``fleet_bench``, one rank of a multi-process delta run and of a
scenario-fleet run; and ``multihost_launch``, which starts a job of such
ranks on one host."""
