"""Observability and fault injection of the port: the metrics registry,
tracer and flight recorder (``utils.tracing``), the time-series rings
(``utils.timeseries``), the quality observatory and golden canary
(``utils.quality``), the step ledger (``utils.steplog``), the compile
sentinel (``utils.compilewatch``), the device-memory ledger and budget
(``utils.hbmledger``, ``utils.hbm_budget``), the decode-step diagnosis
(``utils.perfdiag``), the card's bring-up (``utils.devinit``) and the
seeded chaos points (``utils.chaos``)."""
