"""Observability and fault injection of the port: the metrics registry,
tracer and flight recorder (``utils.tracing``), the quality observatory and
golden canary (``utils.quality``), the step ledger (``utils.steplog``) and
the seeded chaos points (``utils.chaos``)."""
