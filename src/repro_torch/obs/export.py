"""Exporters: JSONL event log + Chrome-trace/Perfetto JSON (port of
``repro.obs.export``, DESIGN.md §15; the same schema, field for field).

Two artifacts per run, both under ``experiments/obs/`` by default:

  * ``<run>.obs.jsonl`` — one JSON object per line; every object has a
    ``kind`` key (``meta`` | ``round`` | ``flush`` | ``serve`` | ``span``
    | ``log``).  This is the canonical record ``repro_torch.obs.report`` reads
    (and the reference's ``repro.obs.report``).
  * ``<run>.perfetto.json`` — Chrome trace-event format (``ph: "X"``
    complete events, microsecond timestamps) loadable in Perfetto UI /
    ``chrome://tracing``.  Wall and virtual clocks export as separate
    ``pid`` tracks so the simulated timeline never interleaves with host
    time.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional

from .trace import Span, Tracer, VIRTUAL

#: pid assignments for the two clock tracks in the Chrome trace
WALL_PID = 1
VIRTUAL_PID = 2

JSONL_KINDS = ("meta", "round", "flush", "serve", "span", "log")


def span_record(span: Span) -> Dict[str, Any]:
    """JSONL form of a span (kind=span; seconds, not µs)."""
    rec: Dict[str, Any] = {
        "kind": "span",
        "name": span.name,
        "cat": span.cat,
        "ts": span.ts,
        "dur": span.dur,
    }
    if span.args:
        rec["args"] = _plain(span.args)
    return rec


def _plain(obj: Any) -> Any:
    """Best-effort conversion to JSON-serializable plain types."""
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    try:
        return float(obj)
    except (TypeError, ValueError, RuntimeError):  # a tensor of many values
        return str(obj)


def to_trace_events(spans: Iterable[Span]) -> List[Dict[str, Any]]:
    """Chrome trace-event list: one ``ph:"X"`` complete event per span."""
    events: List[Dict[str, Any]] = []
    for s in spans:
        virtual = s.cat == VIRTUAL
        events.append({
            "name": s.name,
            "ph": "X",
            "ts": s.ts * 1e6,      # trace-event timestamps are microseconds
            "dur": s.dur * 1e6,
            "pid": VIRTUAL_PID if virtual else WALL_PID,
            "tid": 0,
            "cat": s.cat,
            "args": _plain(s.args),
        })
    return events


def to_perfetto(spans: Iterable[Span]) -> Dict[str, Any]:
    """Full Chrome-trace JSON document with named clock tracks."""
    meta = [
        {"name": "process_name", "ph": "M", "pid": WALL_PID,
         "args": {"name": "wall clock"}},
        {"name": "process_name", "ph": "M", "pid": VIRTUAL_PID,
         "args": {"name": "virtual clock"}},
    ]
    return {
        "traceEvents": meta + to_trace_events(spans),
        "displayTimeUnit": "ms",
    }


def write_jsonl(path: str, records: Iterable[Dict[str, Any]]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(_plain(rec), sort_keys=True) + "\n")
    return path


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def write_perfetto(path: str, tracer: Tracer) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_perfetto(tracer.spans()), f)
    return path


def export_run(
    out_dir: str,
    run_name: str,
    records: List[Dict[str, Any]],
    tracer: Optional[Tracer] = None,
) -> Dict[str, str]:
    """Write both artifacts; returns ``{"jsonl": ..., "perfetto": ...}``.

    Sink records come first in the JSONL (meta, rounds, ...), followed by
    one ``kind=span`` line per recorded span so the log is self-contained
    even without the Perfetto file.
    """
    lines = list(records)
    paths: Dict[str, str] = {}
    if tracer is not None:
        lines.extend(span_record(s) for s in tracer.spans())
    paths["jsonl"] = write_jsonl(
        os.path.join(out_dir, f"{run_name}.obs.jsonl"), lines
    )
    if tracer is not None:
        paths["perfetto"] = write_perfetto(
            os.path.join(out_dir, f"{run_name}.perfetto.json"), tracer
        )
    return paths
