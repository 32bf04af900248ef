"""Observability helpers of the port (counterpart of ``ringpop_tpu/obs``):
so far only the source-provenance read of :mod:`.flight`."""
