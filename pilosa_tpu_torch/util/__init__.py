"""Host-side utilities of the port: pipeline telemetry and the metrics
registry, span tracing, the event journal and the loggers."""

from . import events, stats, tracing
from .events import JOURNAL, Event, EventJournal
from .logger import Logger, NopLogger, StandardLogger, VerboseLogger
from .stats import (
    REGISTRY,
    Counter,
    ExpvarStatsClient,
    Histogram,
    MetricsRegistry,
    MultiStatsClient,
    NopStatsClient,
    PipelineStats,
    StatsClient,
)
from .tracing import NopTracer, ProfilerTracer, Span, TraceContext, Tracer
