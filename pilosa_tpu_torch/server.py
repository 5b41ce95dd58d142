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
15), and process mode, the fault plane, the metrics history and statsd
(item 14).  ``[mesh] devices = -1`` keeps its meaning: no engine, every
query on the host lane.
"""

from __future__ import annotations

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

_ITEM_14 = "Queue 1 item 14 (serving and observability)"
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
    ("faults_rules", "[faults] rules", _ITEM_14),
    ("obs_history", "[observability] history", _ITEM_14),
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

    def _refuse_unported(self):
        cfg, defaults = self.config, Config()
        for attr, key, item in _UNPORTED_KEYS:
            if getattr(cfg, attr) != getattr(defaults, attr):
                raise NotImplementedError(
                    f"{key} = {getattr(cfg, attr)!r}: not served by pilosa_tpu_torch yet: "
                    f"ROADMAP.md {item}")
        if cfg.metric_service == "statsd":
            raise NotImplementedError(
                f"[metric] service = 'statsd': not served by pilosa_tpu_torch yet: "
                f"ROADMAP.md {_ITEM_14}")
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
        if self.config.metric_service == "expvar":
            return ExpvarStatsClient()
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
        self.holder.open()
        if self.config.mesh_devices >= 0:
            # [engine] device-budget-bytes: the soft device working-set
            # target (0: the engine's default, a fraction of the card).
            self.engine = TorchEngine(
                self.holder, device=self.device,
                max_resident_bytes=self.config.engine_device_budget_bytes or None,
                logger=self.logger, journal=self.journal)
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
        self._start_monitors()
        return self

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
        # The diagnostics loop ([metric] diagnostics, util/diagnostics.py)
        # waits for ROADMAP.md Queue 1 item 14; with no version-check URL
        # (the default) the reference's loop sends nothing either.

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
