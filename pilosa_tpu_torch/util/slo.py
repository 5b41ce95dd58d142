"""SLO burn-rate watcher + flight recorder (docs/observability.md).

The SLOWatcher walks the trailing ``[observability] slo-window`` of
self-hosted metrics history (util/history.py) each tick and compares two
objectives against their configured targets:

- **error rate**: ``pilosa_server_errors_total`` rate over
  ``pilosa_server_requests_total`` rate, as a fraction of requests;
- **query latency**: the stored ``pilosa_query_seconds_p95_us``
  quantile, in milliseconds.

An objective BURNS when its observed value exceeds
``target * burn-threshold`` (the classic multi-window burn-rate alarm
reduced to one window — history IS the window).  Burns are
edge-triggered: the transition into burn journals a typed ``slo.burn``
event, flips a ``degraded`` reason into the /readyz body (NON-503: a
degraded node still serves; shedding is the admission controller's
job), and captures a flight-recorder bundle — one JSON document of
recent traces, worst plans, the event-journal tail, engine/residency
state, hints/CQ/fault-plane state, and the breaching window of
``_system`` history — persisted to ``<data-dir>/.flightrec/`` (bounded
count, oldest pruned).  The transition back out journals ``slo.clear``.

The black box you read after the crash: pull ``GET
/debug/flightrecorder`` (or the persisted bundle) BEFORE restarting a
sick node.

A copy of ``pilosa_tpu/util/slo.py``.  The bundle's engine and residency
state come from the port's ``TorchEngine.cache_snapshot`` and its device
section from ``torch.cuda`` (allocated, reserved and peak bytes of the
engine's card); the cluster's hints and the continuous queries join it
with their modules (ROADMAP.md Queue 1 items 13 and 15).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from .stats import METRIC_SLO_BURN, REGISTRY

BUNDLE_PREFIX = "bundle-"


def _device_state(engine) -> Optional[dict]:
    """The engine's card as ``torch.cuda`` reports it (None on the CPU):
    its name and the caching allocator's allocated, reserved and peak
    bytes.  Host-side counters only: nothing here waits on the card."""
    dev = getattr(engine, "device", None)
    if getattr(dev, "type", None) != "cuda":
        return None
    import torch

    return {
        "name": torch.cuda.get_device_name(dev),
        "allocatedBytes": int(torch.cuda.memory_allocated(dev)),
        "reservedBytes": int(torch.cuda.memory_reserved(dev)),
        "peakAllocatedBytes": int(torch.cuda.max_memory_allocated(dev)),
    }


class SLOWatcher:
    def __init__(
        self,
        api,
        history,
        node: str = "",
        error_rate_target: float = 0.0,
        latency_p95_ms_target: float = 0.0,
        window: float = 300.0,
        burn_threshold: float = 2.0,
        data_dir: str = "",
        max_bundles: int = 8,
        now_fn: Callable[[], float] = time.time,
    ):
        self.api = api
        self.history = history
        self.node = node
        self.error_rate_target = float(error_rate_target)
        self.latency_p95_ms_target = float(latency_p95_ms_target)
        self.window = max(1.0, float(window))
        self.burn_threshold = max(1.0, float(burn_threshold))
        self.data_dir = data_dir
        self.max_bundles = max(1, int(max_bundles))
        self._now = now_fn
        self._lock = threading.Lock()
        # slo name -> last evaluated {value, target, burning}
        self._state: Dict[str, dict] = {}
        self._burn_counters = {}
        self.last_tick_ts = 0.0
        self.bundles_written = 0

    # -- evaluation --------------------------------------------------------

    @property
    def degraded(self) -> List[str]:
        """Active burn reasons, e.g. ``["slo:error_rate"]`` — merged
        into the /readyz body (never its status code)."""
        with self._lock:
            return sorted(
                f"slo:{name}"
                for name, st in self._state.items()
                if st.get("burning")
            )

    def _series_sum(self, series: str, since: float, until: float) -> float:
        q = self.history.query(series, since=since, until=until)
        scale = float(q.get("scale", 1) or 1)
        return sum(
            v for pts in q["points"].values() for _, v in pts
        ) / scale

    def _series_max(self, series: str, since: float, until: float) -> float:
        q = self.history.query(series, since=since, until=until)
        scale = float(q.get("scale", 1) or 1)
        vals = [v for pts in q["points"].values() for _, v in pts]
        return max(vals) / scale if vals else 0.0

    def _evaluate(self, now: float) -> Dict[str, dict]:
        since = now - self.window
        out: Dict[str, dict] = {}
        if self.error_rate_target > 0:
            errors = self._series_sum(
                "pilosa_server_errors_total_rate", since, now
            )
            requests = self._series_sum(
                "pilosa_server_requests_total_rate", since, now
            )
            value = errors / requests if requests > 0 else 0.0
            out["error_rate"] = {
                "value": value,
                "target": self.error_rate_target,
                "burnRate": value / self.error_rate_target,
            }
        if self.latency_p95_ms_target > 0:
            p95_us = self._series_max(
                "pilosa_query_seconds_p95_us", since, now
            )
            value = p95_us / 1000.0
            out["latency_p95_ms"] = {
                "value": value,
                "target": self.latency_p95_ms_target,
                "burnRate": value / self.latency_p95_ms_target,
            }
        return out

    def tick(self, now: Optional[float] = None):
        """Evaluate every configured objective; act on edges."""
        if now is None:
            now = self._now()
        evaluated = self._evaluate(now)
        fired: List[str] = []
        cleared: List[str] = []
        with self._lock:
            for name, ev in evaluated.items():
                burning = ev["burnRate"] > self.burn_threshold
                was = self._state.get(name, {}).get("burning", False)
                self._state[name] = dict(ev, burning=burning, ts=now)
                if burning and not was:
                    fired.append(name)
                elif was and not burning:
                    cleared.append(name)
            self.last_tick_ts = now
        journal = getattr(self.api, "journal", None)
        for name in fired:
            ev = evaluated[name]
            c = self._burn_counters.get(name)
            if c is None:
                c = self._burn_counters[name] = REGISTRY.counter(
                    METRIC_SLO_BURN, slo=name
                )
            c.inc()
            if journal is not None:
                journal.append(
                    "slo.burn",
                    message=f"{name} burning: {ev['value']:.6g} vs target "
                    f"{ev['target']:.6g} (burn rate {ev['burnRate']:.3g}x, "
                    f"threshold {self.burn_threshold:g}x)",
                    slo=name,
                    value=ev["value"],
                    target=ev["target"],
                    burnRate=ev["burnRate"],
                    window=self.window,
                )
            try:
                self.persist_bundle(self.flight_bundle(reason=name, now=now))
            except Exception:
                pass  # the journal entry survives even if persist fails
        for name in cleared:
            if journal is not None:
                journal.append(
                    "slo.clear",
                    message=f"{name} back within target",
                    slo=name,
                )
        return evaluated

    # -- flight recorder ---------------------------------------------------

    def flight_bundle(
        self, reason: Optional[str] = None, now: Optional[float] = None
    ) -> dict:
        """One JSON document of everything you'd wish you had after the
        incident — assembled from the live debug surfaces plus the
        breaching window of _system history."""
        if now is None:
            now = self._now()
        api = self.api
        bundle: dict = {
            "kind": "flightrecorder",
            "node": self.node,
            "capturedAt": now,
            "reason": reason or "manual",
            "slo": self.snapshot(),
        }
        tracer = getattr(api, "tracer", None)
        if tracer is not None and hasattr(tracer, "traces"):
            bundle["traces"] = tracer.traces()
        from . import plans as plans_mod

        bundle["plans"] = plans_mod.STORE.to_doc(limit=16)
        journal = getattr(api, "journal", None)
        if journal is not None:
            bundle["events"] = journal.to_doc(limit=128)
        eng = getattr(api, "engine", None)
        if eng is not None and hasattr(eng, "cache_snapshot"):
            try:
                bundle["engineCaches"] = eng.cache_snapshot()
            except Exception:
                pass
            device = _device_state(eng)
            if device is not None:
                bundle["device"] = device
        cq = getattr(api, "_cq", None)
        if cq is not None:
            bundle["continuousQueries"] = cq.snapshot()
        from ..net.faults import PLANE

        if PLANE.active:
            bundle["faults"] = PLANE.snapshot()
        bundle["history"] = self.history.window(self.window, until=now)
        bundle["metrics"] = REGISTRY.snapshot()
        return bundle

    def _flightrec_dir(self) -> str:
        return os.path.join(self.data_dir, ".flightrec")

    def persist_bundle(self, bundle: dict) -> Optional[str]:
        """Atomic write (tmp + fsync + rename) into
        ``<data-dir>/.flightrec/``, pruning the oldest past
        ``flightrec-max-bundles``."""
        if not self.data_dir:
            return None
        d = self._flightrec_dir()
        os.makedirs(d, exist_ok=True)
        reason = str(bundle.get("reason", "manual")).replace(os.sep, "_")
        name = f"{BUNDLE_PREFIX}{int(bundle['capturedAt'])}-{reason}.json"
        path = os.path.join(d, name)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(bundle, fh, default=str)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        self.bundles_written += 1
        existing = sorted(
            fn for fn in os.listdir(d)
            if fn.startswith(BUNDLE_PREFIX) and fn.endswith(".json")
        )
        for fn in existing[: max(0, len(existing) - self.max_bundles)]:
            try:
                os.remove(os.path.join(d, fn))
            except OSError:
                pass
        return path

    def bundle_paths(self) -> List[str]:
        d = self._flightrec_dir()
        if not self.data_dir or not os.path.isdir(d):
            return []
        return sorted(
            os.path.join(d, fn)
            for fn in os.listdir(d)
            if fn.startswith(BUNDLE_PREFIX) and fn.endswith(".json")
        )

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "targets": {
                    "errorRate": self.error_rate_target,
                    "latencyP95Ms": self.latency_p95_ms_target,
                },
                "window": self.window,
                "burnThreshold": self.burn_threshold,
                "state": {n: dict(st) for n, st in self._state.items()},
                "degraded": sorted(
                    f"slo:{n}"
                    for n, st in self._state.items()
                    if st.get("burning")
                ),
                "lastTickTs": self.last_tick_ts,
                "bundlesWritten": self.bundles_written,
            }
