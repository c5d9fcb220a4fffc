"""Synthetic learnable tasks (port of ``repro.data``; the frame task only)."""
