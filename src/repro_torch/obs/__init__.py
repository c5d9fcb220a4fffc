"""Telemetry for the training and serving paths (port of ``repro.obs``).

Only the call sites' side is ported: :func:`null_span`, which the sessions
wrap their payload encodes, decodes and flushes in.  The ``Obs`` handle,
its metrics sink, tracer and exporters are not ported yet (ROADMAP A9), so
``obs=None`` is the only handle a call site accepts; ``log`` holds the
entry points' logger.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Iterator

__all__ = ["null_span"]


@contextmanager
def null_span(obs, name: str, **args: Any) -> Iterator[Dict[str, Any]]:
    """A span for instrumented call sites: with ``obs=None`` it yields its
    ``args`` dict and records nothing.  Any other ``obs`` raises, since
    ``Obs`` is not ported yet (ROADMAP A9)."""
    if obs is not None:
        raise NotImplementedError(
            f"observability (obs=, span {name!r}) is not ported yet (ROADMAP A9)")
    yield args
