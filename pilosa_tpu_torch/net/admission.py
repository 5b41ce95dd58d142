"""Admission control for the serving tier: shed load BEFORE engine work.

A node serving "millions of users" must degrade gracefully: when the
offered load exceeds what the batch pipeline can drain, the right answer
is a FAST 429/503 at the front door — a rejected request costs one
parsed header block, while an admitted one occupies queue slots, memo
probes, a batcher item, and a device-batch seat until its readback
lands.  The reference leans on Go's scheduler and kernel backpressure;
on an accelerator-backed single process the pipeline's capacity is
explicit (depth x batch), so admission can be explicit too.

Two mechanisms, both O(1) per request under one lock:

* **Weighted-fair tenant shares**: each request carries a tenant key
  (the ``X-Pilosa-Tenant`` header, else the target index name, else
  "default").  Once global in-flight crosses ``fair_start`` x
  ``max_inflight``, a tenant may not exceed its share —
  ``weight / sum(active weights) x max_inflight`` in-flight requests —
  and sheds 429 (its own quota; back off).  A lone active tenant's
  share is the whole pipe (work-conserving), so saturating a
  single-tenant node also answers 429 at ``max_inflight``.
* **Global hard cap** (``max_inflight`` + 25% burst headroom): the 503
  backstop.  The headroom is what makes fairness REAL under a hog: the
  hog saturates its share and 429s, while a light tenant arriving at a
  full pipe is still UNDER its share (the active set now includes it)
  and is admitted into the burst margin instead of colliding with the
  hog's 503.

Telemetry: ``pilosa_admission_admitted_total``,
``pilosa_admission_shed_total{reason}``, and pull-time gauges
``pilosa_admission_inflight`` / ``pilosa_admission_active_tenants`` —
the series the ops runbook (docs/serving.md) asserts on.

A copy of ``pilosa_tpu/net/admission.py``.  ``serve`` binds the tenant
ledger (``util/plans.py TenantLedger.bind_admission``) to the controller,
so every recorded plan streams its device-seconds into ``note_cost`` and
fairness prices measured cost, as in the reference.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

from ..util.stats import (
    METRIC_ADMISSION_ADMITTED,
    METRIC_ADMISSION_INFLIGHT,
    METRIC_ADMISSION_SHED,
    METRIC_ADMISSION_TENANTS,
    REGISTRY,
    SHED_REASONS,
)

# Shed responses: (status, reason label, client guidance).
SHED_OVERLOAD = (503, "overload")
SHED_TENANT = (429, "tenant_fair")
SHED_QUEUE = (503, "queue_full")

TENANT_HEADER = "X-Pilosa-Tenant"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _parse_weights(spec: str) -> Dict[str, float]:
    """``"gold=4,free=1"`` -> {"gold": 4.0, "free": 1.0}; unlisted
    tenants weigh 1.0."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        name, sep, w = part.partition("=")
        if not sep or not name.strip():
            continue
        try:
            out[name.strip()] = max(float(w), 0.001)
        except ValueError:
            continue
    return out


class AdmissionController:
    """Bounded-in-flight admission with weighted-fair tenant shedding.

    ``admit(tenant)`` returns None when admitted (caller MUST pair it
    with ``release(tenant)`` exactly once) or a ``(status, reason)``
    shed decision the server answers without touching the engine."""

    def __init__(
        self,
        max_inflight: Optional[int] = None,
        fair_start: Optional[float] = None,
        weights: Optional[Dict[str, float]] = None,
    ):
        if max_inflight is None:
            max_inflight = _env_int("PILOSA_TPU_MAX_INFLIGHT", 1024)
        self.max_inflight = max(1, int(max_inflight))
        if fair_start is None:
            try:
                fair_start = float(os.environ.get("PILOSA_TPU_FAIR_START", 0.5))
            except ValueError:
                fair_start = 0.5
        self.fair_start = min(max(fair_start, 0.0), 1.0)
        if weights is None:
            weights = _parse_weights(
                os.environ.get("PILOSA_TPU_TENANT_WEIGHTS", "")
            )
        self.weights = dict(weights)
        self._lock = threading.Lock()
        self._inflight = 0
        self._tenants: Dict[str, int] = {}
        # tenant -> EWMA device-seconds per query, fed by the tenant
        # ledger (util/plans.py LEDGER.bind_admission): fairness prices
        # a tenant's MEASURED cost, so ten heavy dense sweeps occupy as
        # much share as a hundred memo hits.  Empty until plans flow —
        # with no cost signal the check degrades to pure request count
        # (the pre-ledger behavior, byte-for-byte).
        self._cost: Dict[str, float] = {}
        # Cached per-series handles: the admit path must not take the
        # process-global registry lock per request.
        self._c_admitted = REGISTRY.counter(
            METRIC_ADMISSION_ADMITTED, help="Requests admitted to the engine"
        )
        self._c_shed = {
            r: REGISTRY.counter(
                METRIC_ADMISSION_SHED,
                help="Requests shed before engine work",
                reason=r,
            )
            for r in SHED_REASONS
        }

    # -- admit / release ----------------------------------------------------

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    @property
    def hard_limit(self) -> int:
        """503 backstop: max_inflight plus burst headroom that keeps
        under-share tenants admittable while a hog holds the pipe."""
        return self.max_inflight + max(8, self.max_inflight // 4)

    def admit(self, tenant: str) -> Optional[Tuple[int, str]]:
        with self._lock:
            if self._inflight >= self.hard_limit:
                status, reason = SHED_OVERLOAD
            elif self._over_fair_share(tenant):
                status, reason = SHED_TENANT
            else:
                self._tenants[tenant] = self._tenants.get(tenant, 0) + 1
                self._inflight += 1
                self._c_admitted.inc()
                return None
        self._c_shed[reason].inc()
        return status, reason

    # EWMA smoothing for the measured-cost signal, and the band the
    # relative cost multiplier is clamped to: an expensive tenant can be
    # priced at most 4x a request, a cheap one at least 1/4 — fairness
    # feedback must throttle hogs, never starve a tenant outright.
    COST_EWMA = 0.2
    COST_CLAMP = (0.25, 4.0)

    def note_cost(self, tenant: str, device_seconds: float):
        """Measured-cost feedback from the tenant ledger: one query's
        attributed device-seconds.  Keeps an EWMA per tenant that
        ``_over_fair_share`` prices in-flight occupancy with."""
        with self._lock:
            prev = self._cost.get(tenant)
            if prev is None:
                self._cost[tenant] = device_seconds
            else:
                a = self.COST_EWMA
                self._cost[tenant] = (1 - a) * prev + a * device_seconds
            # Cardinality is bounded upstream: the only caller is the
            # tenant ledger, which folds tenants past its MAX_TENANTS
            # cap into "_other" before accounting.

    def _rel_cost(self, tenant: str, active) -> float:
        """Tenant's cost multiplier vs the active-set mean, clamped.
        Called under the lock.  1.0 when no cost signal exists yet."""
        known = [self._cost[t] for t in active if t in self._cost]
        if not known or tenant not in self._cost:
            return 1.0
        mean = sum(known) / len(known)
        if mean <= 0:
            return 1.0
        lo, hi = self.COST_CLAMP
        return min(hi, max(lo, self._cost[tenant] / mean))

    def _over_fair_share(self, tenant: str) -> bool:
        """True when admitting ``tenant`` would push it past its
        weighted-fair share while the node is loaded enough for
        fairness to be on.  Called under the lock.  The active set
        includes the candidate, so a lone tenant's share is the whole
        pipe and a newly-arriving light tenant's share is computed
        against the hog it shares the node with.  In-flight occupancy
        is priced by measured device cost (``note_cost``): a tenant
        whose queries measure 4x the mean saturates its share with a
        quarter of the requests."""
        if self._inflight < self.fair_start * self.max_inflight:
            return False
        cur = self._tenants.get(tenant, 0)
        if cur == 0:
            # Never-starve floor: a tenant with NOTHING in flight is
            # always admitted, whatever its cost multiplier — without
            # this, a 4x-cost tenant whose share is < 4 slots would be
            # shed at zero in-flight, and since the cost EWMA only moves
            # when a query completes it could never recover.  (This is
            # also the pre-cost-pricing behavior: +1 > max(share, 1.0)
            # was unsatisfiable at cur == 0.)
            return False
        active = set(self._tenants)
        active.add(tenant)
        total_w = sum(self.weight(t) for t in active)
        share = self.weight(tenant) / total_w * self.max_inflight
        occupancy = (cur + 1) * self._rel_cost(tenant, active)
        return occupancy > max(share, 1.0)

    def release(self, tenant: str):
        with self._lock:
            n = self._tenants.get(tenant, 0)
            if n <= 1:
                self._tenants.pop(tenant, None)
            else:
                self._tenants[tenant] = n - 1
            if self._inflight > 0:
                self._inflight -= 1

    def shed_queue_full(self) -> Tuple[int, str]:
        """Record a submit-queue overflow (the bounded worker-pool
        queue) and return its shed decision."""
        status, reason = SHED_QUEUE
        self._c_shed[reason].inc()
        return status, reason

    # -- telemetry ----------------------------------------------------------

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def refresh_gauges(self):
        """Pull-time gauge refresh (Handler._metrics_text): admission
        state is plain ints guarded by our lock; /metrics stamps them
        into the registry only when scraped."""
        with self._lock:
            inflight = self._inflight
            tenants = len(self._tenants)
        REGISTRY.set_gauge(METRIC_ADMISSION_INFLIGHT, inflight)
        REGISTRY.set_gauge(METRIC_ADMISSION_TENANTS, tenants)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "maxInflight": self.max_inflight,
                "fairStart": self.fair_start,
                "inflight": self._inflight,
                "tenants": dict(self._tenants),
                "weights": dict(self.weights),
                # Measured device-seconds-per-query EWMA per tenant —
                # the fairness pricing signal (util/plans.py ledger).
                "costEwma": {
                    t: round(v, 6) for t, v in self._cost.items()
                },
            }


def tenant_of(headers: dict, path: str) -> str:
    """Tenant key for one request: explicit header wins, else the index
    name embedded in the path (the natural multi-tenant boundary), else
    a shared default bucket."""
    t = headers.get(TENANT_HEADER)
    if t:
        return t
    if path.startswith("/index/"):
        rest = path[7:]
        return rest.split("/", 1)[0] or "default"
    return "default"
