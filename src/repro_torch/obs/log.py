"""Thin logger for CLIs (port of ``repro.obs.log``).

Human-readable text on stderr, so machine-readable output on stdout stays
clean.  ``quiet`` silences it.

    log = Logger(quiet=args.quiet)
    log.info("prefill done", prefill_ms=12.5)
"""

from __future__ import annotations

import sys
from typing import Any, Optional, TextIO


class Logger:
    """stderr text lines ``[level] msg k=v ...``."""

    def __init__(self, quiet: bool = False, stream: Optional[TextIO] = None) -> None:
        self.quiet = bool(quiet)
        self.stream = stream if stream is not None else sys.stderr

    def _emit(self, level: str, msg: str, **fields: Any) -> None:
        if self.quiet:
            return
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        print(f"[{level}] {msg} {kv}" if kv else f"[{level}] {msg}", file=self.stream)

    def info(self, msg: str, **fields: Any) -> None:
        self._emit("info", msg, **fields)

    def result(self, msg: str, **fields: Any) -> None:
        """Final-outcome lines."""
        self._emit("result", msg, **fields)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)
