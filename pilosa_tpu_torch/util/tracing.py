"""Tracing: spans around every hot path, with real trace contexts.

A copy of ``pilosa_tpu/util/tracing.py``; its ``ProfilerTracer`` brackets
spans with ``torch.profiler.record_function`` where the reference used
``jax.profiler.TraceAnnotation``.

Mirror of the reference's global Tracer / Span (tracing/tracing.go:11-66),
grown into a propagating tracer: every span carries a ``trace_id`` +
``span_id``, and a parent may be either a live Span (same thread of
control) or a detached TraceContext (a thread hop or a remote peer).
The pipelined query path (parallel/batcher.py) crosses three worker
threads between accept and reply, so the "current span" can no longer be
an implicit ``threading.local`` owned by one Tracer: the slot is
module-level (``current_span``/``attach``), captured explicitly at
submit time and re-attached wherever the work resumes.

Cross-node: ``inject_headers``/``extract_headers`` carry the context as
``X-Trace-Id``/``X-Span-Id`` HTTP headers (the reference sends Jaeger's
uber-trace-id the same way, tracing/opentracing/opentracing.go), so a
remote shard fan-out joins the initiator's trace.

The ProfilerTracer additionally brackets spans with
``torch.profiler.record_function`` so spans land in the profiler's
traces beside the card's kernels — the equivalent of the reference's
Jaeger adapter.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

# Module-level current-span slot: shared by every Tracer so code that
# only has *a* span (a batcher worker, an internal HTTP client) can
# resolve the ambient one without holding a tracer reference.
_LOCAL = threading.local()

# Trace/span ids need uniqueness, not unpredictability: a Mersenne
# PRNG seeded once from the OS beats ``uuid4`` — whose per-call
# ``os.urandom`` is a SYSCALL, tens of µs on some kernels and the
# single largest line item of a memo-hit query — by ~40x.  getrandbits
# on a Random instance mutates its state in one C call under the GIL,
# so concurrent callers are safe.
_RNG = random.Random(int.from_bytes(os.urandom(16), "big"))


def new_id() -> str:
    """A 16-hex-char random id (trace ids and span ids alike)."""
    return f"{_RNG.getrandbits(64):016x}"


def current_span() -> Optional["Span"]:
    """The span the calling thread is currently inside, if any."""
    return getattr(_LOCAL, "current", None)


@contextmanager
def attach(span: Optional["Span"]):
    """Make ``span`` the calling thread's current span for the duration
    of the block — the explicit re-attach half of a thread hop (the
    capture half is just ``current_span()`` on the submitting thread).
    ``attach(None)`` is a no-op block, so callers need not branch on
    tracing being enabled."""
    prev = getattr(_LOCAL, "current", None)
    _LOCAL.current = span if span is not None else prev
    try:
        yield span
    finally:
        _LOCAL.current = prev


def inject_headers(headers: Dict[str, str]):
    """Stamp the calling thread's current span into outbound request
    headers (X-Trace-Id/X-Span-Id/X-Trace-Name) — the single wire-
    propagation implementation (Tracer.inject_headers delegates here,
    and the internal HTTP client calls it without a tracer)."""
    cur = getattr(_LOCAL, "current", None)
    if cur is not None:
        headers["X-Trace-Id"] = cur.trace_id
        headers["X-Span-Id"] = cur.span_id
        headers["X-Trace-Name"] = cur.name


class TraceContext:
    """A detached (trace id, span id) pair: what survives a thread hop
    or an HTTP hop when the Span object itself cannot."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str = ""):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"TraceContext({self.trace_id}, {self.span_id})"


class Span:
    __slots__ = (
        "name",
        "tags",
        "start",
        "start_wall",
        "duration",
        "children",
        "parent",
        "trace_id",
        "span_id",
        "parent_span_id",
        "_tracer",
    )

    def __init__(self, name: str, tags: Optional[dict] = None, parent=None,
                 tracer: Optional["Tracer"] = None):
        self.name = name
        self.tags = tags or {}
        self.start = time.monotonic()
        self.start_wall = time.time()
        self.duration = None
        self.children: List["Span"] = []
        self.span_id = new_id()
        self._tracer = tracer
        if isinstance(parent, Span):
            self.parent = parent
            self.trace_id = parent.trace_id
            self.parent_span_id = parent.span_id
            if tracer is None:
                self._tracer = parent._tracer
        elif isinstance(parent, TraceContext):
            # A remote/detached parent: this span roots a LOCAL tree but
            # rides the caller's trace id, so /debug/traces on every
            # node involved shows trees sharing one trace id.
            self.parent = None
            self.trace_id = parent.trace_id
            self.parent_span_id = parent.span_id
        else:
            self.parent = None
            self.trace_id = new_id()
            self.parent_span_id = ""

    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def set_tag(self, key: str, value):
        self.tags[key] = value

    def child(self, name: str, **tags) -> "Span":
        """Start a child span attached to this span (explicit-parent
        form for worker threads; finish() it when done)."""
        span = Span(name, tags, self)
        self.children.append(span)
        return span

    def record(self, name: str, start: Optional[float] = None,
               duration: float = 0.0, **tags) -> "Span":
        """Append an already-measured child span: ``start`` is a
        time.monotonic timestamp (defaults to now - duration).  This is
        how the pipeline stamps per-stage timings onto a query's tree
        without holding a span open across worker threads."""
        span = Span(name, tags, self)
        self.children.append(span)
        if start is None:
            start = time.monotonic() - duration
        delta = span.start - start
        span.start = start
        span.start_wall -= delta
        span.duration = duration
        return span

    def finish(self):
        self.duration = time.monotonic() - self.start
        if self.parent is None and self._tracer is not None:
            self._tracer._record_finished(self)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "traceID": self.trace_id,
            "spanID": self.span_id,
            "parentSpanID": self.parent_span_id,
            "tags": self.tags,
            "startTime": self.start_wall,
            "durationMs": None if self.duration is None else self.duration * 1e3,
            "children": [c.to_dict() for c in self.children],
        }


class Tracer:
    """Collects span trees; cheap enough to keep always-on.  Finished
    root spans land in two rings: ``recent`` (the last ``keep_finished``)
    and ``slow`` (the last ``keep_slow`` whose duration crossed
    ``slow_threshold`` seconds) — the /debug/traces surface.

    ``keep_finished`` defaults non-zero so /debug/traces works out of
    the box on any tracer-enabled server."""

    DEFAULT_KEEP = 64
    DEFAULT_KEEP_SLOW = 32
    DEFAULT_SLOW_THRESHOLD = 0.100  # seconds

    def __init__(self, keep_finished: int = DEFAULT_KEEP,
                 keep_slow: int = DEFAULT_KEEP_SLOW,
                 slow_threshold: float = DEFAULT_SLOW_THRESHOLD):
        self.keep_finished = keep_finished
        self.slow_threshold = slow_threshold
        # O(1) ring eviction: the old list.pop(0) was O(n) per finished
        # span, paid on every query at serving rates.
        self._finished: "deque[Span]" = deque(maxlen=max(1, keep_finished))
        self._slow: "deque[Span]" = deque(maxlen=max(1, keep_slow))
        self._lock = threading.Lock()

    @contextmanager
    def start_span(self, name: str, parent=None, **tags):
        """Span around the block; nests under the thread's current span
        unless an explicit ``parent`` (Span or TraceContext) is given."""
        if parent is None:
            parent = getattr(_LOCAL, "current", None)
        span = Span(name, tags, parent, tracer=self)
        if isinstance(parent, Span):
            parent.children.append(span)
        prev = getattr(_LOCAL, "current", None)
        _LOCAL.current = span
        try:
            yield span
        finally:
            span.finish()
            _LOCAL.current = prev

    def begin(self, name: str, parent=None, **tags) -> Optional[Span]:
        """Start a span WITHOUT scoping it to this thread: the deferred
        form for work whose completion happens on another thread (the
        caller — or a completion callback — must finish() it).  Nests
        under the thread's current span unless ``parent`` is given."""
        if parent is None:
            parent = getattr(_LOCAL, "current", None)
        span = Span(name, tags, parent, tracer=self)
        if isinstance(parent, Span):
            parent.children.append(span)
        return span

    def _record_finished(self, span: Span):
        if not self.keep_finished:
            return
        with self._lock:
            self._finished.append(span)
            if span.duration is not None and span.duration >= self.slow_threshold:
                self._slow.append(span)

    def finished_spans(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def slow_spans(self) -> List[Span]:
        with self._lock:
            return list(self._slow)

    def traces(self) -> dict:
        """The /debug/traces document: recent + slow root span trees."""
        with self._lock:
            recent = list(self._finished)
            slow = list(self._slow)
        return {
            "recent": [s.to_dict() for s in recent],
            "slow": [s.to_dict() for s in slow],
            "slowThresholdMs": self.slow_threshold * 1e3,
        }

    # HTTP header propagation for cross-node traces
    # (tracing/tracing.go:18-28).
    def inject_headers(self, headers: Dict[str, str]):
        inject_headers(headers)

    def extract_headers(self, headers: Dict[str, str]) -> Optional[TraceContext]:
        """TraceContext from incoming request headers, or None.  Header
        dicts may arrive with original casing; check both forms."""
        trace_id = headers.get("X-Trace-Id") or headers.get("x-trace-id")
        if not trace_id:
            return None
        span_id = headers.get("X-Span-Id") or headers.get("x-span-id") or ""
        return TraceContext(trace_id, span_id)


class NopTracer(Tracer):
    @contextmanager
    def start_span(self, name: str, parent=None, **tags):
        yield None

    def begin(self, name: str, parent=None, **tags):
        return None

    def inject_headers(self, headers: Dict[str, str]):
        pass


class ProfilerTracer(Tracer):
    """Tracer that also emits ``torch.profiler.record_function`` ranges,
    so spans are visible in the profiler's traces next to the kernels
    they launched.  torch is resolved once at construction; every span
    then opens one range."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        import torch.profiler

        self._record = torch.profiler.record_function

    @contextmanager
    def start_span(self, name: str, parent=None, **tags):
        with self._record(name):
            with super().start_span(name, parent=parent, **tags) as span:
                yield span
