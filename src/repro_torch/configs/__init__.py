"""Assigned-architecture configs (``--arch <id>``) + the paper's Conformer
(port of ``repro.configs``: every config of the reference, and the shapes of
its dry-run cells)."""

from .registry import ARCHS, get_arch, list_archs
from .shapes import SHAPES, Shape

__all__ = ["ARCHS", "get_arch", "list_archs", "SHAPES", "Shape"]
