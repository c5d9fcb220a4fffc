"""Federated training and serving over compressed state (port of ``repro.federated``):
cohorts, wire accounting, the paper's loop, the vectorized engine, server state
and the serve-side materializer."""
