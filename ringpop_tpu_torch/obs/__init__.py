"""Live operations plane of the port (counterpart of ``ringpop_tpu/obs``):
in-memory stat aggregation, a pull-based HTTP endpoint, span tracing
through the forwarding planes, a crash flight recorder, alert rules, the
ops controller and the scored game day.

Everything here is host-plane only: it reads records the engines already
fetch and headers the transports already carry, so a run with the plane on
is digest-identical to one with it off.  Endpoint handlers, the cross-rank
collector and the flight recorder swallow their own failures — an
ops-plane socket error never takes a sweep down.  Imports are torch-free
(serve frontends load them without starting a device runtime); anything
that needs the sim plane imports it at call time.

* :mod:`.aggregate` — :class:`AggregatingStats` and the Prometheus text
  renderer.
* :mod:`.endpoint` — :class:`LiveOps`: ``/metrics`` ``/healthz``
  ``/progress`` with rank-0 cross-rank aggregation over its own fabric.
* :mod:`.trace` — :class:`Tracer`: the ``ringpop-trace`` header and
  ``kind:"span"`` records.
* :mod:`.flight` — :class:`FlightRecorder` and :func:`git_commit`.
* :mod:`.rules` — :class:`RuleEngine` with threshold, rate-of-change,
  staleness and cross-rank-skew rules.
* :mod:`.controller` — :class:`OpsController`: alert-driven DGRO
  re-score, ring drain and resize.
* :mod:`.gameday` — a correlated failure injected into a live P=2 fleet,
  the controller judged on time-to-mitigate against a digest-identical
  no-controller twin.
"""

_EXPORTS = {
    "AggregatingStats": "ringpop_tpu_torch.obs.aggregate",
    "render_prometheus": "ringpop_tpu_torch.obs.aggregate",
    "LiveOps": "ringpop_tpu_torch.obs.endpoint",
    "Tracer": "ringpop_tpu_torch.obs.trace",
    "Span": "ringpop_tpu_torch.obs.trace",
    "JsonlSink": "ringpop_tpu_torch.obs.trace",
    "TRACE_HEADER": "ringpop_tpu_torch.obs.trace",
    "trace_id_of": "ringpop_tpu_torch.obs.trace",
    "FlightRecorder": "ringpop_tpu_torch.obs.flight",
    "git_commit": "ringpop_tpu_torch.obs.flight",
    "SPAN_KINDS": "ringpop_tpu_torch.obs.trace",
    "chain": "ringpop_tpu_torch.obs.trace",
    "RuleEngine": "ringpop_tpu_torch.obs.rules",
    "Threshold": "ringpop_tpu_torch.obs.rules",
    "RateOfChange": "ringpop_tpu_torch.obs.rules",
    "Staleness": "ringpop_tpu_torch.obs.rules",
    "CrossRankSkew": "ringpop_tpu_torch.obs.rules",
    "OpsController": "ringpop_tpu_torch.obs.controller",
    "run_gameday": "ringpop_tpu_torch.obs.gameday",
    "gameday_pair": "ringpop_tpu_torch.obs.gameday",
}


def __getattr__(name):
    # lazy like the serve package: importing the package costs nothing
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = list(_EXPORTS)
