"""Observability plane of the port: tracing and metrics.

Copies of the reference's ``obs.trace``, ``obs.metrics`` and
``obs.export`` (trace records as Chrome/Perfetto JSON), all stdlib and
numpy only: the host-side scheduler imports them.
"""

from repro_torch.obs.trace import TraceRecord, Tracer, get_tracer

__all__ = ["TraceRecord", "Tracer", "get_tracer"]
