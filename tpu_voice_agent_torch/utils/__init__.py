"""Observability of the port: the metrics registry and tracer
(``utils.tracing``) and the quality observatory (``utils.quality``)."""
