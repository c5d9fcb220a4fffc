"""Thin structured logger for CLIs (port of ``repro.obs.log``).

One funnel: human-readable text on stderr (so machine-readable output on
stdout stays clean), plus an optional mirror into an :class:`~repro_torch.obs.Obs`
sink as ``kind=log`` JSONL records.  ``quiet`` silences the text only; a
record is cheap and kept whenever a sink is attached.

    log = Logger(quiet=args.quiet, obs=obs)
    log.info("round complete", round=r, loss=loss)
"""

from __future__ import annotations

import sys
from typing import Any, Optional, TextIO


class Logger:
    """stderr text lines ``[level] msg k=v ...``, mirrored into ``obs``."""

    def __init__(self, quiet: bool = False, obs: Optional[Any] = None,
                 stream: Optional[TextIO] = None) -> None:
        self.quiet = bool(quiet)
        self.obs = obs
        self.stream = stream if stream is not None else sys.stderr

    def _emit(self, level: str, msg: str, **fields: Any) -> None:
        if self.obs is not None:
            self.obs.record("log", level=level, msg=msg, **fields)
        if self.quiet:
            return
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        print(f"[{level}] {msg} {kv}" if kv else f"[{level}] {msg}", file=self.stream)

    def info(self, msg: str, **fields: Any) -> None:
        self._emit("info", msg, **fields)

    def warn(self, msg: str, **fields: Any) -> None:
        self._emit("warn", msg, **fields)

    def result(self, msg: str, **fields: Any) -> None:
        """Final-outcome lines."""
        self._emit("result", msg, **fields)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)
