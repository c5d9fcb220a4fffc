"""Federated training and serving over compressed state (port of ``repro.federated``):
cohorts, wire accounting, the paper's loop, the vectorized engine, the
federated round over the server's training state, and the materializer of
both training and serving."""
