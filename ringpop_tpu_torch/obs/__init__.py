"""Observability helpers of the port (counterpart of ``ringpop_tpu/obs``):
so far the source-provenance read of :mod:`.flight` and the span-tracing
header of :mod:`.trace` that the RPC channel reads."""
