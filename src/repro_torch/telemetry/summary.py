"""Summary-table renderer for telemetry JSONL logs.

One markdown table per log: each round stream's first/last/min/max/mean,
then the run's summary facts (or a serve log's latency row).

  PYTHONPATH=src python -m repro_torch.telemetry.summary telemetry.jsonl
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.telemetry.events import read_events, streams_from_events


def _fmt(v) -> str:
    if isinstance(v, float) and not np.isfinite(v):
        return "nan"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _scalarize(row) -> float:
    """One scalar per stream row: vector streams (per-cluster consensus,
    the staleness histogram) report their sum."""
    arr = np.asarray(row, dtype=np.float64)
    return float(arr) if arr.ndim == 0 else float(arr.sum())


def summary_table(events: list[dict]) -> str:
    meta = next((e for e in events if e.get("event") == "run_meta"), None)
    if meta is None:   # serve logs carry serve_meta instead
        meta = next((e for e in events if e.get("event") == "serve_meta"), {})
    summary = next((e for e in events if e.get("event") == "summary"), {})
    serve = next((e for e in events if e.get("event") == "serve_summary"), None)
    streams = streams_from_events(events)
    title = meta.get("method") or meta.get("arch") or "run"
    lines = [f"## telemetry — {title}", ""]
    facts = []
    for k in ("rounds", "n_clients", "n_clusters", "seed"):
        if k in meta:
            facts.append(f"{k}={meta[k]}")
    for k in ("mean_acc", "final_loss", "comm_bytes", "wire_bytes",
              "wall_s", "n_compiles", "n_dispatches"):
        if k in summary:
            facts.append(f"{k}={_fmt(summary[k])}")
    if facts:
        lines += [" · ".join(facts), ""]
    if streams:
        lines += [
            "| stream | first | last | min | max | mean |",
            "|---|---:|---:|---:|---:|---:|",
        ]
        for name in sorted(streams):
            per_round = np.asarray([_scalarize(row) for row in streams[name]])
            with np.errstate(invalid="ignore"):
                lines.append(
                    f"| {name} | {_fmt(per_round[0])} "
                    f"| {_fmt(per_round[-1])} "
                    f"| {_fmt(float(np.nanmin(per_round)))} "
                    f"| {_fmt(float(np.nanmax(per_round)))} "
                    f"| {_fmt(float(np.nanmean(per_round)))} |"
                )
        lines.append("")
    if serve is not None:
        lines += [
            "| serve | requests | qps | p50 ms | p95 ms | p99 ms "
            "| dispatches | dequant |",
            "|---|---:|---:|---:|---:|---:|---:|---:|",
            f"| {meta.get('codec', '?')} | {serve.get('requests', 0)} "
            f"| {_fmt(serve.get('qps', 0.0))} "
            f"| {_fmt(serve.get('p50_ms', float('nan')))} "
            f"| {_fmt(serve.get('p95_ms', float('nan')))} "
            f"| {_fmt(serve.get('p99_ms', float('nan')))} "
            f"| {serve.get('n_dispatches', 0)} "
            f"| {serve.get('dequant_calls', 0)} |",
            "",
        ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", help="telemetry JSONL file(s)")
    args = ap.parse_args(argv)
    for path in args.paths:
        print(summary_table(read_events(path)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
