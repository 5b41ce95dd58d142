"""Pipeline telemetry: a fixed-bucket latency histogram and the per-stage
stats of the count batcher, and the names of the fused-program series.

Copies of ``Histogram`` and ``PipelineStats`` from
``pilosa_tpu/util/stats.py``, minus the process metrics registry that
feeds ``/metrics`` there (ROADMAP.md Queue 1 item 14 ports that surface):
the stats live on the batcher that records them and are read through its
``pipeline_snapshot()``, and the engine's fusion counters are plain
attributes, named below with the series they will feed.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Tuple

# -- whole-dashboard fusion (pilosa_tpu/util/stats.py:379-400) ---------------
#   pilosa_engine_fused_program_programs_total   drains launched as fused
#                                                programs (TorchEngine.fused_programs)
#   pilosa_engine_fused_program_queries_total    items that rode them
#                                                (fused_program_queries)
#   pilosa_engine_fused_program_masks_evaluated_total  distinct Row subtrees
#                                                evaluated (fused_masks_evaluated)
#   pilosa_engine_fused_program_masks_referenced_total subtree references the
#                                                drains asked for; the gap to
#                                                masks_evaluated is the
#                                                evaluations fusion saved
#                                                (fused_masks_referenced)
METRIC_ENGINE_FUSED_PROGRAMS = "pilosa_engine_fused_program_programs_total"
METRIC_ENGINE_FUSED_QUERIES = "pilosa_engine_fused_program_queries_total"
METRIC_ENGINE_FUSED_MASKS_EVAL = "pilosa_engine_fused_program_masks_evaluated_total"
METRIC_ENGINE_FUSED_MASKS_REF = "pilosa_engine_fused_program_masks_referenced_total"

# Fixed log-spaced latency buckets (seconds), 100 us .. 60 s.  Fixed
# buckets (not reservoirs) keep observe() O(log B) with bounded memory.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram:
    """Fixed-bucket latency histogram with linear-interpolation quantile
    estimation.  Thread-safe; observe() is a bisect + one locked
    increment."""

    __slots__ = ("buckets", "_counts", "sum", "count", "_lock")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float):
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self.sum += value
            self.count += 1

    def export(self) -> Tuple[List[int], float, int]:
        """One consistent (counts, sum, count) triple taken under the lock."""
        with self._lock:
            return list(self._counts), self.sum, self.count

    def _quantile_of(self, counts: List[int], total: int, q: float) -> float:
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c > 0:
                hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
        return self.buckets[-1]

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1) by linear interpolation inside the
        containing bucket; 0.0 on an empty histogram, and observations in
        the +Inf bucket clamp to the top finite bound."""
        counts, _, total = self.export()
        return self._quantile_of(counts, total, q)

    def snapshot(self) -> dict:
        counts, total_sum, count = self.export()  # one consistent view
        return {
            "count": count,
            "sumSeconds": round(total_sum, 6),
            "meanSeconds": round(total_sum / count, 6) if count else 0.0,
            "p50": round(self._quantile_of(counts, count, 0.50), 6),
            "p95": round(self._quantile_of(counts, count, 0.95), 6),
            "p99": round(self._quantile_of(counts, count, 0.99), 6),
        }


class PipelineStats:
    """Per-stage telemetry for the pipelined count path
    (``parallel/batcher.py``): stage timings (queue wait, lower+dispatch,
    device+readback, decode), the live/high-water in-flight batch depth,
    and batch-occupancy counters.  Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        # stage -> [count, total_seconds, max_seconds]
        self._stages: Dict[str, list] = {}
        self._gauges: Dict[str, float] = {}
        self._counters: Dict[str, int] = {}
        # stage -> Histogram (quantiles in snapshot()).
        self._hists: Dict[str, Histogram] = {}

    def record(self, stage: str, seconds: float, n: int = 1):
        with self._lock:
            s = self._stages.setdefault(stage, [0, 0.0, 0.0])
            s[0] += n
            s[1] += seconds
            s[2] = max(s[2], seconds)
            h = self._hists.get(stage)
            if h is None:
                h = self._hists[stage] = Histogram()
        h.observe(seconds)

    def gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = value

    def gauge_max(self, name: str, value: float):
        """Keep the high-water mark (e.g. the largest batch seen)."""
        with self._lock:
            if value > self._gauges.get(name, float("-inf")):
                self._gauges[name] = value

    def incr(self, name: str, value: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def add_delta(self, name: str, delta: int):
        """Adjust a gauge by ``delta`` and track its high-water twin
        (``<name>_max``) in the same critical section — the pattern for
        in-flight depth counters."""
        with self._lock:
            v = self._gauges.get(name, 0) + delta
            self._gauges[name] = v
            if v > self._gauges.get(name + "_max", 0):
                self._gauges[name + "_max"] = v
            return v

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            stages = {
                k: {
                    "count": c,
                    "totalSeconds": round(t, 6),
                    "meanSeconds": round(t / c, 6) if c else 0.0,
                    "maxSeconds": round(m, 6),
                }
                for k, (c, t, m) in self._stages.items()
            }
            hists = dict(self._hists)
            gauges = dict(self._gauges)
            counters = dict(self._counters)
        for k, h in hists.items():
            if k in stages:
                snap = h.snapshot()
                stages[k]["p50Seconds"] = snap["p50"]
                stages[k]["p95Seconds"] = snap["p95"]
                stages[k]["p99Seconds"] = snap["p99"]
        return {
            "stages": stages,
            "gauges": gauges,
            "counters": counters,
        }
