"""Server: the long-running node process, on one card.

Mirror of the reference's pilosa.Server + server.Command assembly
(server.go:100-801, server/server.go:56-414): owns the holder, the
translate store, the ``TorchEngine``, the API and the HTTP listener.
``open`` brings them up in the reference's order (translate -> holder ->
engine -> API -> listener -> monitors).

The port of the single-node part of ``pilosa_tpu/server.py``.  A Server
runs on the card unless ``device`` names another (``"cpu"`` in tests):
with no card it raises, and nothing falls back to the host.  The config
keys of parts this port does not serve yet are refused at construction,
each naming the ROADMAP.md item that ports it (``_refuse_unported``):
the cluster, gossip, translate replication and multi-host keys (item
15).  ``[mesh] devices = -1`` keeps its meaning: no engine, every query
on the host lane.

Besides the listener the node runs the reference's monitors: the fault
plane's identity and boot rules (``[faults]``), the self-hosted metrics
history and SLO watcher (``[observability] history = true``), statsd
(``[metric] service = statsd``), diagnostics (``[metric] diagnostics``),
and the per-tenant device-cost EWMAs persisted in ``<data-dir>/.tenant_costs``
across restarts (warm start builds the hottest tenants first).
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from typing import Optional

from .api import API
from .config import Config
from .core.fragment import ACK_LEVELS
from .core.holder import Holder
from .core.translate import TranslateFile
from .net import serve
from .net.admission import AdmissionController, _parse_weights
from .net.server import bind_http, make_server_ssl_context
from .parallel.engine import TorchEngine
from .parallel.mesh import resolve_device
from .util import (
    REGISTRY,
    EventJournal,
    ExpvarStatsClient,
    NopStatsClient,
    NopTracer,
    ProfilerTracer,
    StandardLogger,
    Tracer,
    VerboseLogger,
)

_ITEM_15 = "Queue 1 item 15 (multi-GPU and multi-host)"

# Config attributes this port does not serve yet, and the ROADMAP.md item
# that ports each: a value other than the default raises at construction.
_UNPORTED_KEYS = (
    ("cluster_coordinator", "[cluster] coordinator", _ITEM_15),
    ("cluster_replicas", "[cluster] replicas", _ITEM_15),
    ("cluster_hosts", "[cluster] hosts", _ITEM_15),
    ("cluster_replica_read", "[cluster] replica-read", _ITEM_15),
    ("cluster_freshness_ms", "[cluster] freshness-ms", _ITEM_15),
    ("cluster_hint_max_bytes", "[cluster] hint-max-bytes", _ITEM_15),
    ("cluster_hint_max_age", "[cluster] hint-max-age", _ITEM_15),
    ("cluster_recovery_holddown_ms", "[cluster] recovery-holddown-ms", _ITEM_15),
    ("gossip_port", "[gossip] port", _ITEM_15),
    ("gossip_seeds", "[gossip] seeds", _ITEM_15),
    ("gossip_probe_interval", "[gossip] probe-interval", _ITEM_15),
    ("gossip_probe_timeout", "[gossip] probe-timeout", _ITEM_15),
    ("gossip_push_pull_interval", "[gossip] push-pull-interval", _ITEM_15),
    ("gossip_suspicion_mult", "[gossip] suspicion-mult", _ITEM_15),
    ("translation_primary_url", "[translation] primary-url", _ITEM_15),
    ("jax_coordinator", "[mesh] coordinator", _ITEM_15),
    ("jax_num_processes", "[mesh] processes", _ITEM_15),
    ("jax_process_id", "[mesh] process-id", _ITEM_15),
    ("mesh_peers", "[mesh] peers", _ITEM_15),
    ("mesh_sequencer", "[mesh] sequencer", _ITEM_15),
)


def _advertise_uri(host: str, port: int, scheme: str = "http") -> str:
    """Dialable URI for the advertised node address: wildcard binds
    ('', '0.0.0.0') are listen addresses, advertised as 'localhost'."""
    if host in ("", "0.0.0.0"):
        host = "localhost"
    return f"{scheme}://{host}:{port}"


class Server:
    def __init__(self, config: Optional[Config] = None, device=None):
        self.config = config or Config()
        # Fail fast on enum-valued keys, naming the offending key.
        if self.config.storage_ack not in ACK_LEVELS:
            raise ValueError(
                f"[storage] ack = {self.config.storage_ack!r}: expected "
                f"one of {', '.join(ACK_LEVELS)}"
            )
        if self.config.cluster_replica_read not in ("primary", "any", "bounded"):
            raise ValueError(
                f"[cluster] replica-read = "
                f"{self.config.cluster_replica_read!r}: expected "
                "primary, any, or bounded"
            )
        self._refuse_unported()
        self.device = resolve_device(device)
        self.data_dir = os.path.expanduser(self.config.data_dir)
        self.logger = self._make_logger()
        self.stats = self._make_stats()
        self.tracer = self._make_tracer()
        self.holder = Holder(self.data_dir, ack=self.config.storage_ack, device=self.device)
        self.translate_store = TranslateFile(os.path.join(self.data_dir, ".keys"))
        self.node_id = self._load_node_id()
        # Per-node structured event journal, served at GET /debug/events
        # and mirrored into the log.
        self.journal = EventJournal(node=self.node_id, logger=self.logger)
        self.api: Optional[API] = None
        self.engine: Optional[TorchEngine] = None
        self._http = None
        self._http_thread = None
        self._closing = threading.Event()
        self._monitors = []
        self.diagnostics = None

    def _refuse_unported(self):
        cfg, defaults = self.config, Config()
        for attr, key, item in _UNPORTED_KEYS:
            if getattr(cfg, attr) != getattr(defaults, attr):
                raise NotImplementedError(
                    f"{key} = {getattr(cfg, attr)!r}: not served by pilosa_tpu_torch yet: "
                    f"ROADMAP.md {item}")
        if cfg.mesh_devices not in (-1, 0, 1):
            raise NotImplementedError(
                f"[mesh] devices = {cfg.mesh_devices!r}: one card serves here; more are "
                f"ROADMAP.md {_ITEM_15}")

    # -- assembly ----------------------------------------------------------

    def _make_logger(self):
        if self.config.verbose:
            return VerboseLogger()
        return StandardLogger()

    def _make_stats(self):
        svc = self.config.metric_service
        if svc == "expvar":
            return ExpvarStatsClient()
        if svc == "statsd":
            try:
                from .util.statsd import StatsdClient

                return StatsdClient(self.config.metric_host)
            except Exception:
                return NopStatsClient()
        return NopStatsClient()

    def _make_tracer(self):
        t = self.config.tracing_sampler_type
        if t == "profiler":
            return ProfilerTracer()
        if t == "span":
            # The default: always-on span tracer with the recent + slow
            # /debug/traces rings.
            return Tracer()
        # "none" — and any unrecognized value: an operator's typo for
        # "none" must not silently enable span retention.
        if t not in ("none", "nop", ""):
            self.logger.printf(
                "unknown tracing.sampler-type %r: tracing disabled", t
            )
        return NopTracer()

    def _load_node_id(self) -> str:
        """Stable node ID persisted to .id (server.go:409)."""
        os.makedirs(self.data_dir, exist_ok=True)
        p = os.path.join(self.data_dir, ".id")
        if os.path.exists(p):
            with open(p) as f:
                return f.read().strip()
        node_id = uuid.uuid4().hex[:16]
        with open(p, "w") as f:
            f.write(node_id)
        return node_id

    # -- lifecycle (server.go Open :334) -----------------------------------

    def open(self, port_override: Optional[int] = None):
        host, port = self.config.bind_host_port()
        if port_override is not None:
            port = port_override
        # Bind the HTTP socket first (without serving): an ephemeral
        # port must resolve to the real bound port before /status
        # advertises it.
        ssl_ctx = None
        if self.config.tls_certificate:
            ssl_ctx = make_server_ssl_context(
                self.config.tls_certificate, self.config.tls_key
            )
        self._http = bind_http(
            host if host not in ("", "0.0.0.0") else "0.0.0.0", port,
            ssl_context=ssl_ctx,
            **self._server_opts(),
        )
        port = self._http.server_address[1]
        try:
            return self._open_bound(host, port)
        except Exception:
            # Release the bound-but-never-served socket, or a retry on
            # the same port gets EADDRINUSE.
            self._http.server_close()
            self._http = None
            raise

    def _open_bound(self, host: str, port: int):
        self.journal.node = self.node_id
        self.translate_store.open()
        self._setup_faults(host, port)
        self.holder.open()
        if self.config.mesh_devices >= 0:
            # [engine] device-budget-bytes: the soft device working-set
            # target (0: the engine's default, a fraction of the card).
            self.engine = TorchEngine(
                self.holder, device=self.device,
                max_resident_bytes=self.config.engine_device_budget_bytes or None,
                logger=self.logger, journal=self.journal)
            # Seed the warm start's cost order from the last run's
            # per-tenant device-cost EWMAs: a restarted node re-warms its
            # hot tenants' stacks first.
            self._load_tenant_costs()
        node = {"id": self.node_id, "uri": _advertise_uri(host, port, self.scheme),
                "isCoordinator": True}
        self.api = API(
            holder=self.holder,
            translate_store=self.translate_store,
            engine=self.engine,
            with_engine=self.engine is not None,
            stats=self.stats,
            tracer=self.tracer,
            long_query_time=self.config.cluster_long_query_time,
            logger=self.logger,
            journal=self.journal,
            node=node,
        )
        self._http, self._http_thread = serve(
            self.api,
            srv=self._http,
            allowed_origins=self.config.handler_allowed_origins,
            admission=self._make_admission(),
        )
        self.logger.printf(
            "pilosa-tpu listening on %s:%d (node %s, %s)", host, port, self.node_id,
            self.device,
        )
        # After serve(): process-mode sampling needs api.process_server and
        # the handler, both wired by serve().
        self._setup_observability()
        self._start_monitors()
        return self

    def _setup_faults(self, host: str, port: int):
        """Stamp this node's identity (node id, advertised HTTP endpoint)
        onto the process-global fault plane and install the boot-time
        ``[faults]`` rules."""
        from .net.faults import PLANE

        PLANE.set_local({self.node_id, _advertise_uri(host, port, self.scheme)})
        if self.config.faults_rules:
            PLANE.configure(self.config.faults_rules, self.config.faults_seed)
            self.journal.append("faults.configure", rules=len(self.config.faults_rules),
                                seed=self.config.faults_seed, via="config")

    def _setup_observability(self):
        """The self-hosted metrics history and the SLO watcher: a
        background tick samples every registry series into the ``_system``
        index (util/history.py) and evaluates the configured SLO burn
        rates against it (util/slo.py).  Off unless ``[observability]
        history = true``."""
        cfg = self.config
        if not cfg.obs_history:
            return
        from .util.heat import HEAT
        from .util.history import HistorySampler
        from .util.slo import SLOWatcher

        snapshot_fn = None
        ps = self.api.process_server
        if ps is not None:
            # Process mode: one history for the whole node, sampled from
            # the aggregated exposition /metrics serves (this process and
            # every worker's registry), parsed back into snapshot shape.
            from .util.stats import snapshot_from_exposition

            handler = getattr(getattr(self._http, "RequestHandlerClass", None), "handler",
                              None)
            if handler is not None:
                snapshot_fn = lambda: snapshot_from_exposition(  # noqa: E731
                    ps.aggregate_metrics(handler))
        self.api.history = HistorySampler(
            self.api, node=self.node_id, interval=cfg.obs_sample_interval,
            retention=cfg.obs_retention, snapshot_fn=snapshot_fn)
        # Pull-time gauges refresh just before each sample, so the history
        # tracks the residency gap at tick granularity.
        self.api.history.pre_tick_hooks.append(HEAT.refresh_gauges)
        self.api.slo = SLOWatcher(
            self.api, self.api.history, node=self.node_id,
            error_rate_target=cfg.obs_slo_error_rate,
            latency_p95_ms_target=cfg.obs_slo_latency_p95_ms,
            window=cfg.obs_slo_window, burn_threshold=cfg.obs_slo_burn_threshold,
            data_dir=self.data_dir, max_bundles=cfg.obs_flightrec_max_bundles)
        self.journal.append("observability.start", interval=cfg.obs_sample_interval,
                            retention=cfg.obs_retention, processMode=ps is not None)
        self._spawn(self._observability_tick, cfg.obs_sample_interval)

    def _observability_tick(self):
        self.api.history.tick()
        self.api.slo.tick()

    def _server_opts(self) -> dict:
        """Serving-tier knobs for bind_http (docs/serving.md): backend
        selection plus the event-loop server's reactor/pool/parse
        bounds.  The threaded backend consumes only ``backend``."""
        cfg = self.config
        opts = {"backend": cfg.server_backend}
        if cfg.server_backend != "threaded":
            opts.update(
                reactors=cfg.server_reactors,
                workers=cfg.server_workers,
                pool_workers=cfg.server_pool_workers,
                queue_depth=cfg.server_queue_depth,
                max_body_bytes=cfg.server_max_body_bytes,
                read_timeout=cfg.server_read_timeout,
                idle_timeout=cfg.server_idle_timeout,
            )
            if cfg.server_workers > 0:
                # Process mode terminates TLS in the workers, which need
                # the PATHS (an SSLContext cannot cross a process).
                opts.update(tls_certificate=cfg.tls_certificate, tls_key=cfg.tls_key)
        return opts

    def _make_admission(self):
        """Admission controller for the event-loop backend; None keeps
        the threaded oracle admission-free."""
        if self.config.server_backend == "threaded":
            return None
        return AdmissionController(
            max_inflight=self.config.server_max_inflight,
            fair_start=self.config.server_fair_start,
            weights=_parse_weights(self.config.server_tenant_weights),
        )

    @property
    def scheme(self) -> str:
        """'https' when TLS serving is configured, else 'http'."""
        return "https" if self.config.tls_certificate else "http"

    @property
    def port(self) -> int:
        return self._http.server_address[1]

    def _start_monitors(self):
        # Warm start (docs/durability.md): upload the just-opened stacks
        # to the card on a background thread while this node already
        # answers; /readyz reports `warming` until they are resident.
        if self.config.storage_warm_start and self.engine is not None and self.holder.indexes:
            self.engine.warm_state = {"total": 0, "built": 0, "skipped": 0, "done": False}
            t = threading.Thread(target=self._warm_start, daemon=True, name="warm-start")
            t.start()
            self._monitors.append(t)
        # Cache flush ticker (holder.go cacheFlushInterval :78).
        self._spawn(self._monitor_cache_flush, 60.0)
        # Runtime metrics loop (server.go monitorRuntime :726).
        if self.config.metric_poll_interval > 0:
            self._spawn(self._monitor_runtime, self.config.metric_poll_interval)
        # Diagnostics loop (server.go monitorDiagnostics :675); with no
        # endpoint and no version-check URL (the defaults) nothing leaves
        # the host.
        if self.config.metric_diagnostics:
            from .util.diagnostics import Diagnostics

            self.diagnostics = Diagnostics(
                api=self.api, logger=self.logger,
                version_url=self.config.diagnostics_version_url).start()

    def _warm_start(self):
        try:
            ws = self.engine.warm_start()
            self.logger.printf(
                "warm-start done: %d/%d stacks resident (%d skipped)",
                ws["built"], ws["total"], ws["skipped"],
            )
            self.journal.append("engine.warm_start", built=ws["built"],
                                skipped=ws["skipped"], total=ws["total"])
        except Exception as e:  # noqa: BLE001 — warming must not kill boot
            self.logger.printf("warm-start failed: %s", e)
            ws = self.engine.warm_state
            if ws is not None:
                ws["done"] = True  # never pin readyz on a failed warm

    def _spawn(self, fn, interval: float):
        def loop():
            while not self._closing.wait(interval):
                try:
                    fn()
                except Exception as e:  # monitors never kill the server
                    self.logger.printf("monitor error: %s", e)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self._monitors.append(t)

    def _monitor_cache_flush(self):
        for idx in self.holder.indexes.values():
            for f in idx.fields.values():
                for v in f.views.values():
                    for frag in v.fragments.values():
                        frag.flush_cache()
        # The per-tenant cost EWMAs persist on the same tick: a small
        # snapshot that orders the next boot's warm start.
        self._save_tenant_costs()

    # Persisted per-tenant device-cost EWMAs: the warm start's order
    # survives restarts.
    TENANT_COSTS_FILE = ".tenant_costs"

    def _tenant_costs_path(self) -> str:
        return os.path.join(self.data_dir, self.TENANT_COSTS_FILE)

    def _save_tenant_costs(self):
        from .util import plans as plans_mod

        try:
            snap = plans_mod.LEDGER.ewma_snapshot()
            if not snap:
                return
            tmp = self._tenant_costs_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({t: round(v, 9) for t, v in snap.items()}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._tenant_costs_path())
        except Exception as e:  # noqa: BLE001 — telemetry persistence
            self.logger.printf("tenant-cost snapshot failed: %s", e)

    def _load_tenant_costs(self):
        from .util import plans as plans_mod

        try:
            with open(self._tenant_costs_path()) as f:
                doc = json.load(f)
            if isinstance(doc, dict):
                plans_mod.LEDGER.seed_costs(doc)
        except FileNotFoundError:
            pass
        except Exception as e:  # noqa: BLE001 — a corrupt snapshot: cold order
            self.logger.printf("tenant-cost snapshot unreadable: %s", e)

    def _monitor_runtime(self):
        """Runtime metrics loop (server.go monitorRuntime :726-790:
        goroutines/GC/open-FDs become threads/gc-collections/open-FDs)."""
        import gc
        import resource

        usage = resource.getrusage(resource.RUSAGE_SELF)
        self.stats.gauge("maxrss_kb", usage.ru_maxrss)
        self.stats.gauge("threads", threading.active_count())
        for gen, st in enumerate(gc.get_stats()):
            self.stats.gauge(f"gc.gen{gen}.collections", st["collections"])
        try:
            self.stats.gauge("openFiles", len(os.listdir("/proc/self/fd")))
        except OSError:
            pass

    def close(self):
        self._closing.set()
        self.journal.append("server.shutdown", node=self.node_id)
        # Persist the warm start's order before teardown.
        self._save_tenant_costs()
        if self.diagnostics is not None:
            self.diagnostics.close()
        # The engine closes only after the HTTP socket stops accepting.
        if self._http is not None:
            if self._http_thread is not None:
                # shutdown() waits on an event only serve_forever() sets.
                self._http.shutdown()
            self._http.server_close()
        for t in self._monitors:
            if t.name == "warm-start":
                t.join()
        # Release the engine's device buffers before the holder closes.
        if self.engine is not None:
            try:
                self.engine.close()
            except Exception as e:  # noqa: BLE001 — teardown must not raise
                self.logger.printf("engine close failed: %s", e)
            try:
                REGISTRY.prometheus_text()
            except Exception as e:  # noqa: BLE001
                self.logger.printf("metrics registry unreadable after engine close: %s", e)
        self.holder.close()
        self.translate_store.close()
