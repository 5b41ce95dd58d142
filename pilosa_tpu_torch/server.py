"""Server: the long-running node process, on one card.

Mirror of the reference's pilosa.Server + server.Command assembly
(server.go:100-801, server/server.go:56-414): owns the holder, the
translate store, the cluster, the ``TorchEngine``, the API and the HTTP
listener.  ``open`` brings them up in the reference's order (translate ->
cluster and gossip -> holder -> engine -> API -> listener -> monitors).

The port of ``pilosa_tpu/server.py``.  A Server runs on the card unless
``device`` names another (``"cpu"`` in tests): with no card it raises, and
nothing falls back to the host.  ``[cluster] hosts``, ``[gossip] seeds`` or
``[cluster] coordinator = true`` make the node a cluster member
(``_setup_cluster``): placement and replication (``[cluster] replicas``),
hinted handoff (``[cluster] hint-max-bytes``), SWIM gossip membership
(``[gossip]``), anti-entropy every ``[anti-entropy] interval``, and the
translate log replicated from ``[translation] primary-url``.  ``[mesh]
coordinator``, ``processes`` and ``process-id`` make the node one rank of
a multi-process mesh (``parallel/multihost.py``: a gloo group joined before
the holder opens); ``[mesh] peers`` are the other ranks' nodes, to which
every collective is handed in two phases (``_broadcast_dispatch``), and
``[mesh] sequencer`` (``self`` or the sequencer's URI) gives the
collectives tickets, so that any node may initiate.  ``[mesh] devices =
-1`` keeps its meaning: no engine, every query on the host lane; more
devices than the process has leaves the node without an engine, as the
reference's does, and a single-process mesh over several cards is refused
(``_refuse_unported``).

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
import time
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
from .parallel import multihost
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

# A single-process mesh over several cards waits for a machine with a
# second card (ROADMAP.md).
_MULTI_CARD = "Queue 1 item 15 part D (a single-process mesh over several cards)"


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
        try:
            holddown = float(self.config.cluster_recovery_holddown_ms)
        except (TypeError, ValueError):
            holddown = -1.0
        if holddown < 0:
            raise ValueError(
                f"[cluster] recovery-holddown-ms = "
                f"{self.config.cluster_recovery_holddown_ms!r}: expected "
                "a non-negative number of milliseconds"
            )
        if int(self.config.cluster_hint_max_bytes) < 0:
            raise ValueError(
                f"[cluster] hint-max-bytes = "
                f"{self.config.cluster_hint_max_bytes!r}: expected >= 0 "
                "(0 disables hinted handoff)"
            )
        if float(self.config.cluster_hint_max_age) <= 0:
            raise ValueError(
                f"[cluster] hint-max-age = "
                f"{self.config.cluster_hint_max_age!r}: expected a "
                "positive duration"
            )
        self._refuse_unported()
        if device is None and self.config.jax_coordinator:
            # A mesh rank's card: its process id modulo the cards here.
            device = multihost.rank_device(self.config.jax_process_id)
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
        self.cluster = None
        self.gossip = None
        self.hints = None  # the HintManager, wired in _setup_cluster
        self.syncer = None
        self._membership_events = None
        # Internal clients per (uri, timeout), reused across calls.
        self._client_cache = {}
        self._http = None
        self._http_thread = None
        # The peer fan-out pool of a mesh rank with [mesh] peers.
        self._mesh_pool = None
        self._closing = threading.Event()
        # Set once the node serves: NodeStatus goes to peers only then.
        self._opened = threading.Event()
        self._monitors = []
        self.diagnostics = None

    def _refuse_unported(self):
        """``[mesh] devices`` above 1 that the process's cards could hold:
        one process over several cards is not served (more devices than
        the process has leave the node without an engine, in
        ``_make_engine``, as in the reference)."""
        n = self.config.mesh_devices
        if 1 < n <= multihost.local_device_count():
            raise NotImplementedError(
                f"[mesh] devices = {n!r}: a rank serves one card here; a single-process "
                f"mesh over several is ROADMAP.md {_MULTI_CARD}")

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
        # The harness may set node_id after construction: stamp the
        # journal's node label before any component appends.
        self.journal.node = self.node_id
        # The process group comes up before the holder opens (the analogue
        # of setupNetworking preceding holder.Open, server/server.go:302).
        if self.config.jax_coordinator:
            multihost.initialize(
                coordinator_address=self.config.jax_coordinator,
                num_processes=self.config.jax_num_processes or None,
                process_id=(self.config.jax_process_id
                            if self.config.jax_num_processes else None))
            self.logger.printf("mesh process group up: rank %d/%d on %s",
                               multihost.process_index(), multihost.process_count(),
                               self.device)
        self.translate_store.open()
        self._setup_cluster(host, port)
        self._setup_faults(host, port)
        self.holder.open()
        if self.cluster is not None:
            self.cluster.holder = self.holder
        if self.config.mesh_devices >= 0:
            self.engine = self._make_engine()
        if self.engine is not None and self.config.mesh_sequencer:
            self.engine.ticket = self._make_ticket_fn()
        if self.cluster is not None:
            node = self.cluster.node
        else:
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
            cluster=self.cluster,
        )
        # The readiness probe's gossip-convergence check reads the
        # transport (None without gossip).
        self.api.gossip = self.gossip
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
        self._opened.set()
        if self.cluster is not None:
            self._tell_status()
        return self

    def _make_engine(self) -> Optional[TorchEngine]:
        """The node's engine, None when it cannot be made: a ``[mesh]
        devices`` past the cards this process has, as the reference's
        make_mesh refuses it (the node then serves from the host lane).
        With ``[mesh] peers`` every collective is handed to them first
        (``_broadcast_dispatch``), so that their ranks join it."""
        try:
            n, have = self.config.mesh_devices, multihost.local_device_count()
            if n > have:
                raise ValueError(f"requested {n} devices, only {have} available")
            # [engine] device-budget-bytes: the soft device working-set
            # target (0: the engine's default, a fraction of the card).
            engine = TorchEngine(
                self.holder, device=self.device,
                max_resident_bytes=self.config.engine_device_budget_bytes or None,
                logger=self.logger, journal=self.journal)
        except ValueError as e:
            self.logger.printf("mesh engine unavailable: %s", e)
            return None
        # Seed the warm start's cost order from the last run's per-tenant
        # device-cost EWMAs: a restarted node re-warms its hot tenants'
        # stacks first.
        self._load_tenant_costs()
        if self.config.mesh_peers:
            from concurrent.futures import ThreadPoolExecutor

            self._mesh_pool = ThreadPoolExecutor(
                max_workers=max(4, len(self.config.mesh_peers)),
                thread_name_prefix="mesh-peer")
            engine.collective_broadcast = self._broadcast_dispatch
        return engine

    def _make_ticket_fn(self):
        """Collective tickets (symmetric initiation): the local counter when
        this node is the sequencer, else one HTTP round trip to it."""
        target = self.config.mesh_sequencer
        if target == "self":
            return lambda: self.api.mesh_ticket()

        def fetch():
            # 10 s: a dead sequencer must not stall dispatchers for the
            # client's whole default timeout.
            doc = self._make_client(target, timeout=10.0)._post("/internal/mesh/ticket", {})
            return int(doc["seq"])

        return fetch

    def _broadcast_dispatch(self, kind, payload):
        """Two-phase handoff of a collective's descriptor to every peer
        (pilosa_tpu/server.py:459-517).  Accept: each peer validates and
        registers the dispatch without entering it, so a peer that is down
        or refuses raises here and the others get an abort: a partial
        fan-out never strands a rank in a collective no peer joins.
        Commit, only after every peer accepted: the peers queue the
        replay.  A peer that accepted and never hears a commit (this
        process died mid-handoff) expires its entry instead of entering
        the collective (API.MESH_PENDING_TIMEOUT)."""
        did = uuid.uuid4().hex

        def post(url, body):
            self._make_client(url, timeout=self.config.mesh_dispatch_timeout)._do(
                "POST", "/internal/mesh/dispatch", body, content_type="application/json")

        def fanout(body):
            futures = [self._mesh_pool.submit(post, url, body) for url in self.config.mesh_peers]
            errs = []
            for url, f in zip(self.config.mesh_peers, futures):
                try:
                    f.result(timeout=35)
                except Exception as e:  # noqa: BLE001 — every peer's error is reported
                    errs.append(f"{url}: {e}")
            return errs

        accept = json.dumps(dict(payload, kind=kind, did=did, phase="accept")).encode()
        # The resolutions carry the ticket too: a peer that REJECTED the
        # accept never registered the did, but its seq gate still has to
        # skip the ticket the other peers took into their streams.
        resolution = {"did": did}
        if payload.get("seq") is not None:
            resolution["seq"] = payload["seq"]
        errs = fanout(accept)
        if errs:
            # Release the peers that DID accept; one the abort misses
            # expires the entry on its own timer.
            fanout(json.dumps(dict(resolution, phase="abort")).encode())
            raise RuntimeError(f"mesh peers unavailable: {'; '.join(errs)}")
        errs = fanout(json.dumps(dict(resolution, phase="commit")).encode())
        if errs:
            # Peers the commit missed expire and abort; those it reached
            # enter a collective that cannot complete without the others,
            # so the query fails loudly here.
            raise RuntimeError(f"mesh commit failed (peers will expire): {'; '.join(errs)}")

    def _setup_cluster(self, host: str, port: int):
        """Wire the cluster when hosts, gossip seeds, or the coordinator
        role are configured (server/server.go setupNetworking :302);
        single-node otherwise.  The coordinator case matters for
        bootstrap: the FIRST node of a gossip-joined cluster has no
        seeds and no static host list, but must still start its gossip
        listener for followers to join."""
        if self.config.cluster_disabled or not (
            self.config.cluster_hosts
            or self.config.gossip_seeds
            or self.config.cluster_coordinator
        ):
            return
        from .cluster import Cluster, Node

        uri = _advertise_uri(host, port, self.scheme)
        self.cluster = Cluster(
            # One card a node: every node weighs 1 in placement.
            node=Node(self.node_id, uri, self.config.cluster_coordinator, devices=1),
            replica_n=self.config.cluster_replicas,
            hosts=self.config.cluster_hosts,
            path=self.data_dir,
            client_factory=self._make_client,
            logger=self.logger,
            journal=self.journal,
        )
        # Replica-read routing policy (docs/durability.md).
        self.cluster.replica_read = self.config.cluster_replica_read
        self.cluster.freshness_ms = self.config.cluster_freshness_ms
        self.cluster.recovery_holddown = (
            float(self.config.cluster_recovery_holddown_ms) / 1000.0
        )
        # Hinted handoff (docs/durability.md): durable bounded replay
        # queues for writes to DOWN owners; hint-max-bytes 0 keeps the
        # pre-hint skip-or-fail-loud policy.
        if int(self.config.cluster_hint_max_bytes) > 0:
            from .cluster.hints import HintManager

            self.hints = HintManager(
                self.data_dir,
                node_id=self.node_id,
                max_bytes=self.config.cluster_hint_max_bytes,
                max_age=self.config.cluster_hint_max_age,
                ack=self.config.storage_ack,
                journal=self.journal,
                logger=self.logger,
            )
            self.hints.cluster = self.cluster
            self.cluster.hints = self.hints
            self.hints.start()
        if (
            not self.config.cluster_hosts
            and not self.config.gossip_seeds
            and len(self.cluster.nodes) <= 1
        ):
            # Lone bootstrap coordinator: serve NORMAL immediately (one
            # READY node is a healthy cluster of one); followers joining
            # later re-run the state machine via membership events.  The
            # node-count check matters on RESTART: a persisted .topology
            # may have restored absent peers, and those must re-form via
            # membership before the cluster reports healthy.
            self.cluster._determine_state()
        self._setup_gossip(uri)

    def _setup_gossip(self, uri: str):
        """SWIM membership feeding cluster join/leave events
        (gossip/gossip.go eventReceiver :317-396)."""
        from .cluster import Node
        from .cluster.gossip import GossipNode

        cluster = self.cluster

        # Membership events drain through a serialized worker (the
        # reference's joiningLeavingNodes channel + listenForJoins
        # goroutine, cluster.go:1095-1145): a join that triggers a
        # resize JOB blocks until the job completes, and that must never
        # stall the SWIM probe/ack loop the callbacks run on.
        import queue as queue_mod

        events: "queue_mod.Queue" = queue_mod.Queue()

        def membership_worker():
            while True:
                item = events.get()
                if item is None:
                    return
                kind, member = item
                try:
                    if kind == "join":
                        cluster.add_node(
                            Node(
                                member.id,
                                member.meta.get("uri"),
                                member.meta.get("coordinator", False),
                                devices=member.meta.get("devices", 1),
                            )
                        )
                    else:
                        cluster.node_failed(member.id)
                except Exception as e:
                    self.logger.printf(
                        "membership %s for %s failed: %s", kind, member.id, e
                    )

        self._membership_events = events
        t = threading.Thread(
            target=membership_worker, daemon=True, name="membership"
        )
        t.start()
        self._monitors.append(t)

        def on_join(member):
            if member.meta.get("uri"):
                events.put(("join", member))

        def on_leave(member):
            events.put(("leave", member))

        def on_message(payload):
            # Gossip-delivered cluster messages (SendAsync receive path)
            # dispatch like HTTP /internal/cluster/message bodies.
            if isinstance(payload, dict) and self.api is not None:
                try:
                    self.api.cluster_message(payload)
                except Exception as e:
                    self.logger.printf("gossip message failed: %s", e)

        self.gossip = GossipNode(
            self.node_id,
            meta={
                "uri": uri,
                "coordinator": self.config.cluster_coordinator,
                # Placement weight: capacity-weighted shard ownership
                # reads this from every member's metadata.
                "devices": self.cluster.node.devices,
            },
            port=self.config.gossip_port,
            probe_interval=self.config.gossip_probe_interval,
            probe_timeout=self.config.gossip_probe_timeout,
            suspicion_mult=self.config.gossip_suspicion_mult,
            on_join=on_join,
            on_leave=on_leave,
            on_message=on_message,
            # Direct-liveness evidence feeds the freshness registry
            # bounded replica reads consult (docs/durability.md).
            on_alive=cluster.note_heartbeat,
            logger=self.logger,
            journal=self.journal,
        ).start()
        cluster.gossip_send_async = self.gossip.send_async
        if self.config.gossip_seeds:
            # Seed joins RETRY in the background until another member is
            # known: a one-shot join silently strands a node that boots
            # before its seed (concurrent cluster bring-up — the normal
            # case under an orchestrator).  The reference's memberlist
            # Join is likewise driven until it reports contact
            # (gossip/gossip.go joinWithRetry pattern).
            def join_seeds():
                deadline = time.monotonic() + 120.0
                while (
                    not self._closing.is_set()
                    and time.monotonic() < deadline
                ):
                    for seed in self.config.gossip_seeds:
                        h, _, p = seed.rpartition(":")
                        try:
                            self.gossip.join((h or "127.0.0.1", int(p)))
                        except Exception as e:
                            self.logger.debugf("seed join failed: %s", e)
                    if len(self.gossip.members) > 1:
                        return
                    time.sleep(0.5)

            t = threading.Thread(
                target=join_seeds, daemon=True, name="gossip-join"
            )
            t.start()
            self._monitors.append(t)

    def _tell_status(self):
        """Send this node's NodeStatus (schema and available shards) to each
        peer once, on a thread, retrying a peer until it answers (120 s at
        most).  A departure from the reference, whose nodes learn a peer's
        shards at their first anti-entropy pass (Go Pilosa's memberlist
        push-pull carries the same NodeStatus): a cluster started on data
        directories written beforehand, or restarted from its persisted
        topology, routes to every shard as soon as its nodes serve."""

        def run():
            me = self.cluster.node.id
            pending = [n.id for n in self.cluster.nodes if n.id != me]
            deadline = time.monotonic() + 120.0
            while pending and not self._closing.is_set() and time.monotonic() < deadline:
                for node_id in list(pending):
                    node = self.cluster.node_by_id(node_id)
                    try:
                        if node is not None:
                            self.cluster.send_to(node, self.cluster.node_status())
                        pending.remove(node_id)
                    except Exception:  # noqa: BLE001 — not serving yet: try again
                        pass
                self._closing.wait(0.5 if pending else 0)

        t = threading.Thread(target=run, daemon=True, name="node-status")
        t.start()
        self._monitors.append(t)

    def _setup_faults(self, host: str, port: int):
        """Stamp this node's identity (node id, advertised HTTP endpoint,
        bound gossip endpoint) onto the process-global fault plane and
        install the boot-time ``[faults]`` rules: one partition body POSTed
        to every node lets each enforce only its own side."""
        from .net.faults import PLANE

        addrs = {self.node_id, _advertise_uri(host, port, self.scheme)}
        if self.gossip is not None:
            addrs.add(f"{self.gossip.addr[0]}:{self.gossip.addr[1]}")
        PLANE.set_local(addrs)
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

    def _make_client(self, uri: str, timeout: float = 30.0):
        """Cluster-internal client honoring tls.skip-verify for
        self-signed deployments (http/client.go GetHTTPClient).  Cached
        per (uri, timeout): on https the skip-verify SSLContext loads
        the system CA bundle from disk, far too expensive to rebuild on
        the per-second replication poll or per-dispatch ticket fetch."""
        from .net import InternalClient

        key = (uri, timeout)
        c = self._client_cache.get(key)
        if c is None:
            c = InternalClient(
                uri, timeout=timeout,
                tls_skip_verify=self.config.tls_skip_verify,
                # Per-attempt socket bound < the whole-request deadline:
                # a black-holed dial to a mid-restart peer must leave
                # deadline for the backoff budget (and the mapper's
                # hedge) to engage, instead of one connect eating the
                # full timeout (docs/durability.md).
                attempt_timeout=min(10.0, timeout),
            )
            self._client_cache[key] = c
        return c

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
        if self.cluster is not None:
            self.start_anti_entropy()
        # Diagnostics loop (server.go monitorDiagnostics :675); with no
        # endpoint and no version-check URL (the defaults) nothing leaves
        # the host.
        if self.config.metric_diagnostics:
            from .util.diagnostics import Diagnostics

            self.diagnostics = Diagnostics(
                api=self.api, logger=self.logger,
                version_url=self.config.diagnostics_version_url).start()
        # Translate-log replication from the primary (translate.go
        # monitorReplication :358-432).
        if self.config.translation_primary_url:
            self.translate_store.read_only = True
            self._spawn(self._replicate_translate, 1.0)

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

    def _replicate_translate(self):
        client = self._make_client(self.config.translation_primary_url)
        data = client.translate_data(self.translate_store.size())
        if data:
            self.translate_store.apply_log(data)

    def start_anti_entropy(self, interval: Optional[float] = None):
        """Spawn the anti-entropy loop (server.go monitorAntiEntropy
        :430-483).  Callable after a late cluster attach (test harness)."""
        from .cluster.syncer import HolderSyncer

        self.syncer = HolderSyncer(
            self.holder, self.cluster, self.logger, journal=self.journal
        )

        def sync_and_clean():
            self.syncer.sync_holder()
            # Drop fragments this node no longer owns (holder.go
            # holderCleaner :852-902).
            self.cluster.clean_holder()
            # Re-exchange NodeStatus (schema + per-field available shards)
            # over the reliable fan-out: a create-shard gossip broadcast
            # whose retransmit budget drained before reaching some node is
            # repaired here within one anti-entropy interval
            # (server.go NodeStatus :626-674).
            self.cluster.send_sync(self.cluster.node_status())

        self._spawn(
            sync_and_clean,
            interval
            if interval is not None
            else self.config.anti_entropy_interval,
        )

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
        if self._membership_events is not None:
            self._membership_events.put(None)
        if self.gossip is not None:
            self.gossip.close()
        if self.hints is not None:
            # Stop the replay worker and flush the queue files: pending
            # hints are durable, and a restart resumes their replay.
            self.hints.close()
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
        if self._mesh_pool is not None:
            self._mesh_pool.shutdown(wait=False)
        self.holder.close()
        self.translate_store.close()
