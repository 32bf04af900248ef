"""Host utilities of the port (counterpart of ``ringpop_tpu/util``): so far
``metrics``' ``Histogram``, for the serve tier's telemetry."""
