"""Structured JSONL event log: the host-side export of a run's telemetry.

One JSON object per line, in the JAX package's schema:

  {"event": "run_meta",  "method", "rounds", "streams": [...], plus the
                         caller's meta (e.g. "seed", "n_clients")}
  {"event": "round",     "round": r, <one key per stream: scalars as
                         floats, per-cluster and histogram streams as
                         lists>, ["train_acc"] on evaluated rounds}
  {"event": "summary",   "mean_acc", "std_acc", "comm_bytes",
                         "wire_bytes", "wall_s", "n_compiles",
                         "n_dispatches", ["staleness"]}

Serve events (``launch/serve --telemetry-out``):

  {"event": "serve_meta",    "arch", "codec", "n_clusters", "plane_bytes"}
  {"event": "serve_batch",   "entry", "batch", "latency_ms"}
  {"event": "serve_summary", "codec", "n_clusters", "plane_bytes",
                             "n_compiles", "n_dispatches", "dequant_calls",
                             "batches", "requests", "p50_ms", "p95_ms",
                             "p99_ms", "qps"}

``n_compiles`` is the port's count of programs built
(``counters.compile_count``): the CUDA graphs a replayed run captured (0
on the loop) or the decode engines a server built. Floats are written as
Python floats (repr-exact JSON), so write then parse gives every value
back bit for bit at float64: fp32 stream values widen exactly on the way
in. NaN streams are written as ``NaN``, as Python's ``json`` writes them.
"""
from __future__ import annotations

import json

import numpy as np


def jsonable(v):
    """numpy scalars and arrays -> exact-round-trip JSON values."""
    if isinstance(v, np.ndarray):
        return [jsonable(x) for x in v.tolist()] if v.ndim > 0 else jsonable(v.item())
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: jsonable(x) for k, x in v.items()}
    return v


def write_events(path: str, events: list[dict]) -> None:
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(jsonable(e)) + "\n")


def read_events(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def run_events(result, meta: dict | None = None) -> list[dict]:
    """RunResult -> the event list. ``result.telemetry`` (the round
    streams) expands into one ``round`` event per round; a run without
    them still gets run_meta and summary, with its eval curve as sparse
    ``round`` events."""
    tel = getattr(result, "telemetry", None) or {}
    streams = dict(tel.get("streams", {}))
    head = {
        "event": "run_meta",
        "method": result.method,
        "rounds": tel.get("rounds", len(result.curve)),
        "streams": sorted(streams),
    }
    head.update(meta or {})
    events = [head]
    curve = dict(result.curve)
    rounds = int(tel.get("rounds", 0))
    if streams:
        for r in range(rounds):
            row = {"event": "round", "round": r}
            for name in sorted(streams):
                row[name] = streams[name][r]
            if r in curve:
                row["train_acc"] = curve[r]
            events.append(row)
    else:
        for r, acc in result.curve:
            events.append({"event": "round", "round": r, "train_acc": acc})
    summary = {
        "event": "summary",
        "mean_acc": result.mean_acc,
        "std_acc": result.std_acc,
        "comm_bytes": result.comm_bytes,
        "wire_bytes": result.wire_bytes,
        "wall_s": result.wall_s,
    }
    for k in ("n_compiles", "n_dispatches", "staleness"):
        if k in result.extras:
            summary[k] = result.extras[k]
    events.append(summary)
    return events


def write_run_jsonl(path: str, result, meta: dict | None = None) -> None:
    """The run exporter: RunResult -> JSONL file."""
    write_events(path, run_events(result, meta))


def streams_from_events(events: list[dict]) -> dict:
    """Parse ``round`` events back into {stream: (rounds, ...) float64
    array}: the inverse of ``run_events``."""
    rows = [e for e in events if e.get("event") == "round"]
    rows.sort(key=lambda e: e["round"])
    out = {}
    if not rows:
        return out
    for name in rows[0]:
        if name in ("event", "round"):
            continue
        if all(name in e for e in rows):
            out[name] = np.asarray([e[name] for e in rows])
    return out
