"""Host-side counters: programs built and serve-path latency.

``compile_count`` is the one count of programs built across the port: the
experiment runner (``extras["n_captures"]`` and ``extras["n_compiles"]``:
the CUDA graphs a replayed run captured, one per host-side branch) and the
serve path (``ClusterPlaneServer.n_compiles``: one decode engine per shape
key) report through it, so "one program" means the same thing
everywhere. The port compiles nothing per call: its programs are captured
rounds and decode steps (on the CPU, the closures that stand for them).
The loop engine builds none and reports 0, where the JAX package's loop
reports its one jitted step.

``LatencyStats`` is the JAX package's serve-latency accumulator.
"""
from __future__ import annotations

import time


def compile_count(programs) -> int:
    """The number of programs built: the size of the mapping or sequence
    that holds them (a replayed run's graphs by branch, a server's decode
    engines by shape key)."""
    return len(programs)


class LatencyStats:
    """Per-batch serve latency accumulator (host wall clock).

    ``record`` takes one batch measured to device completion; ``snapshot``
    reports the latency percentiles and sustained QPS (requests served
    over the recording wall-span). Percentiles use the nearest-rank method
    on the sorted sample: exact and deterministic, no interpolation.
    """

    def __init__(self):
        self.latencies_s: list[float] = []
        self.requests = 0
        self._t_first = None
        self._t_last = None

    def record(self, seconds: float, batch: int = 1) -> None:
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now - seconds
        self._t_last = now
        self.latencies_s.append(float(seconds))
        self.requests += int(batch)

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile of the recorded batch latencies (s)."""
        if not self.latencies_s:
            return float("nan")
        xs = sorted(self.latencies_s)
        rank = max(1, -(-int(p) * len(xs) // 100))   # ceil(p/100 * n)
        return xs[min(rank, len(xs)) - 1]

    @property
    def qps(self) -> float:
        if not self.latencies_s:
            return 0.0
        span = (self._t_last or 0.0) - (self._t_first or 0.0)
        busy = sum(self.latencies_s)
        denom = span if span > 0 else busy
        return self.requests / denom if denom > 0 else 0.0

    def snapshot(self) -> dict:
        return {
            "batches": len(self.latencies_s),
            "requests": self.requests,
            "p50_ms": self.percentile(50) * 1e3,
            "p95_ms": self.percentile(95) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
            "qps": self.qps,
        }
