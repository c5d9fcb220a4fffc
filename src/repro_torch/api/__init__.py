"""Wire codec and serving session (port of ``repro.api``)."""
