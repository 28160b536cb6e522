"""Observability: engine step telemetry, request tracing, the flight
recorder, and the conformance instruments (HBM ledger, SLO burn rates,
perf sentinel). Copies of the reference's ``obs/`` modules; stdlib only,
so the engine and the serving layer may both depend on them."""
