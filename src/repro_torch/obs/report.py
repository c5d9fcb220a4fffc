"""Round-health report CLI: ``python -m repro_torch.obs.report <run.obs.jsonl>``
(port of ``repro.obs.report``).

Renders the JSONL event log written by :meth:`repro_torch.obs.Obs.flush` (or the
reference's ``repro.obs.Obs.flush``: the schema is the same) into
a terminal summary:

  * run meta + kernel dispatch counts (per ``op.backend``: launches in the
    port, traces in the reference; ROADMAP C9),
  * per-round table (loss, quant-error norm, update norm, wire bytes)
    with the **quality-per-wire-MB trajectory** — cumulative loss drop
    divided by cumulative wire MB, the paper's headline trade-off,
  * async flush health: staleness histogram, stale/dropped upload
    fractions, peak in-flight bytes,
  * serve latency (p50/p95, swap stall) when a serve record is present,
  * span summary per clock (count / total / mean wall or virtual time).

The standard library and the JSONL only (no torch in this module), so it
reads a run from either package, or from another machine.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional

from .export import read_jsonl


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.5g}"
    return str(v)


def _table(rows: List[Dict[str, Any]], cols: List[str],
           out) -> None:
    if not rows:
        return
    widths = {c: max(len(c), *(len(_fmt(r.get(c, ""))) for r in rows))
              for c in cols}
    print("  " + "  ".join(c.rjust(widths[c]) for c in cols), file=out)
    for r in rows:
        print("  " + "  ".join(_fmt(r.get(c, "")).rjust(widths[c])
                               for c in cols), file=out)


def _histogram(values: List[float], bins: int = 8) -> List[str]:
    if not values:
        return []
    lo, hi = min(values), max(values)
    if hi <= lo:
        return [f"  [{_fmt(lo)}] {'#' * min(len(values), 40)} {len(values)}"]
    step = (hi - lo) / bins
    counts = [0] * bins
    for v in values:
        i = min(int((v - lo) / step), bins - 1)
        counts[i] += 1
    peak = max(counts)
    lines = []
    for i, c in enumerate(counts):
        bar = "#" * max(1, int(40 * c / peak)) if c else ""
        lines.append(
            f"  [{_fmt(lo + i * step):>8} – {_fmt(lo + (i + 1) * step):>8}]"
            f" {bar} {c}"
        )
    return lines


def render(records: List[Dict[str, Any]], out=None) -> None:
    out = out if out is not None else sys.stdout
    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for r in records:
        by_kind.setdefault(str(r.get("kind", "?")), []).append(r)

    for meta in by_kind.get("meta", []):
        print(f"== run: {meta.get('run', '?')} ==", file=out)
        counts = meta.get("dispatch_counts") or {}
        if counts:
            print("kernel dispatch (per op.backend; launches in the port, traces "
                  "in the reference):", file=out)
            for key in sorted(counts):
                print(f"  {key}: {counts[key]}", file=out)

    rounds = by_kind.get("round", [])
    if rounds:
        print(f"\n== rounds ({len(rounds)}) ==", file=out)
        cum_mb = 0.0
        loss0: Optional[float] = None
        rows = []
        for r in rounds:
            loss = r.get("loss")
            if loss0 is None and loss is not None:
                loss0 = float(loss)
            mb = (float(r.get("down_bytes", 0)) +
                  float(r.get("up_bytes", 0))) / 1e6
            cum_mb += mb
            row = dict(r)
            row["wire_mb"] = mb
            if loss0 is not None and loss is not None and cum_mb > 0:
                row["qual_per_mb"] = (loss0 - float(loss)) / cum_mb
            rows.append(row)
        cols = ["round", "loss", "qerr_norm", "update_norm", "ef_norm",
                "alive", "wire_mb", "qual_per_mb"]
        cols = [c for c in cols if any(c in r for r in rows)]
        _table(rows, cols, out)
        if rows and "qual_per_mb" in rows[-1]:
            print(f"  final quality-per-wire-MB: "
                  f"{_fmt(rows[-1]['qual_per_mb'])}", file=out)

    flushes = by_kind.get("flush", [])
    if flushes:
        print(f"\n== async flushes ({len(flushes)}) ==", file=out)
        stal: List[float] = []
        for f in flushes:
            stal.extend(float(s) for s in f.get("staleness", []))
        if stal:
            print("staleness histogram (rounds behind at flush):", file=out)
            for line in _histogram(stal):
                print(line, file=out)
        last = flushes[-1]
        for key in ("stale_fraction", "dropped_fraction",
                    "peak_in_flight_bytes", "up_bytes", "down_bytes"):
            if key in last:
                print(f"  {key}: {_fmt(last[key])}", file=out)

    serves = by_kind.get("serve", [])
    if serves:
        print(f"\n== serve ==", file=out)
        for s in serves:
            for key in ("queries", "query_ms_p50", "query_ms_p95",
                        "swap_ms_mean", "swap_stall_ratio"):
                if key in s:
                    print(f"  {key}: {_fmt(s[key])}", file=out)

    spans = by_kind.get("span", [])
    if spans:
        print(f"\n== spans ({len(spans)}) ==", file=out)
        agg: Dict[str, Dict[str, float]] = {}
        for s in spans:
            key = f"{s.get('cat', 'wall')}:{s.get('name', '?')}"
            rec = agg.setdefault(key, {"count": 0.0, "total_s": 0.0})
            rec["count"] += 1
            rec["total_s"] += float(s.get("dur", 0.0))
        rows = [
            {"span": k, "count": int(v["count"]),
             "total_s": v["total_s"],
             "mean_ms": 1e3 * v["total_s"] / max(v["count"], 1.0)}
            for k, v in sorted(agg.items())
        ]
        _table(rows, ["span", "count", "total_s", "mean_ms"], out)

    logs = by_kind.get("log", [])
    if logs:
        print(f"\n== log ({len(logs)} records) ==", file=out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a round-health summary from an obs JSONL log.",
    )
    ap.add_argument("jsonl", help="path to a <run>.obs.jsonl event log")
    args = ap.parse_args(argv)
    try:
        records = read_jsonl(args.jsonl)
    except OSError as e:
        print(f"error: cannot read {args.jsonl}: {e}", file=sys.stderr)
        return 1
    render(records)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
