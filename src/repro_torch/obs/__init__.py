"""Logging for the entry points (port of ``repro.obs.log``)."""
