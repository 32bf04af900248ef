"""Command-line entry points of the port (counterpart of ``ringpop_tpu/cli``):
``multihost_bench``, one rank of a multi-process delta run, and
``multihost_launch``, which starts a job of such ranks on one host."""
