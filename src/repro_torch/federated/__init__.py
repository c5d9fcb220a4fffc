"""Compressed server state and the serve-side materializer (port of ``repro.federated``)."""
