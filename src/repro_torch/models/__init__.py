"""Model families (port of ``repro.models``; the dense transformer only)."""
