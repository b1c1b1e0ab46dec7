"""Serve-latency SLO tracking: exact p50/p99 over a sliding window
(counterpart of ``euler_tpu/serving/slo.py``).

The native ``serve:total`` histogram is log2-bucketed (cheap to scrape,
about 2x coarse at the tail); an SLO verdict wants exact order
statistics over recent traffic. This tracker keeps the last ``window``
successful request latencies in a ring and reports exact percentiles
against the configured target, next to the histogram families.
"""

from __future__ import annotations

import math
import threading

# Every N records the tracker pushes its window p50/p99 and lifetime
# violations into the engine's serve-SLO gauges, so metrics_text() reads
# live serving latency (eg_serve_slo_ms{quantile=...}) without draining
# the server. The push sorts the window: every 32nd request it is noise
# next to a dispatch.
_PUSH_EVERY = 32


class SLOTracker:
    """p50/p99 of served request latency against a target, over a ring of
    the most recent ``window`` successful completions."""

    def __init__(self, target_ms: float, window: int = 2048):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.target_ms = float(target_ms)
        self.window = int(window)
        self._ring = [0.0] * self.window
        self._count = 0  # total recorded (the ring holds min(count, window))
        self._violations = 0  # recorded samples over target, lifetime
        self._lock = threading.Lock()

    def record(self, total_us: float) -> None:
        ms = float(total_us) / 1e3
        with self._lock:
            self._ring[self._count % self.window] = ms
            self._count += 1
            if ms > self.target_ms:
                self._violations += 1
            push_due = self._count == 1 or self._count % _PUSH_EVERY == 0
        if push_due:
            self.push_gauges()

    def push_gauges(self) -> None:
        """Refresh the engine's live gauges (eg_serve_slo_ms,
        eg_serve_slo_violations_total) from the current window."""
        from euler_tpu_torch.graph.native import lib

        p50 = self.percentile(50)
        p99 = self.percentile(99)
        with self._lock:
            violations, count = self._violations, self._count
        lib().eg_serve_slo_set(
            int(p50 * 1000), int(p99 * 1000), violations, count
        )

    def percentile(self, q: float) -> float:
        """Exact q-th percentile (nearest rank) of the window; 0.0 when
        empty."""
        with self._lock:
            n = min(self._count, self.window)
            if n == 0:
                return 0.0
            ordered = sorted(self._ring[:n])
        rank = max(int(math.ceil(q / 100.0 * n)), 1)
        return ordered[rank - 1]

    def report(self) -> dict:
        """One verdict: counts, exact p50/p99 ms over the window, lifetime
        violations, and ``ok`` (window p99 <= target)."""
        p50 = self.percentile(50)
        p99 = self.percentile(99)
        with self._lock:
            count = self._count
            violations = self._violations
        return {
            "target_ms": self.target_ms,
            "count": count,
            "p50_ms": round(p50, 3),
            "p99_ms": round(p99, 3),
            "violations": violations,
            "ok": count == 0 or p99 <= self.target_ms,
        }
