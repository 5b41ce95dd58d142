"""Server configuration: TOML file + env vars + CLI flags.

A copy of ``pilosa_tpu/config.py``: every key, default, environment
variable and the ``generate-config`` text are the reference's, so one
config file serves either package.  ``pilosa_tpu_torch.server.Server``
refuses the keys this port does not serve yet, naming the ROADMAP.md item
that ports them.

Mirror of the reference's Config (server/config.go:36-152) with the same
TOML key names and precedence (flags > env > file > defaults,
cmd/server.go).  Env vars use the reference's convention with the
PILOSA_TPU_ prefix: ``PILOSA_TPU_DATA_DIR``, ``PILOSA_TPU_BIND``,
``PILOSA_TPU_CLUSTER_COORDINATOR``, ...
"""

from __future__ import annotations

import os
import re
import tomllib
from typing import List

ENV_PREFIX = "PILOSA_TPU_"


def _parse_duration(v) -> float:
    """Go-style duration strings ("10m", "1h30m", "500ms") -> seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    total = 0.0
    for num, unit in re.findall(r"([0-9.]+)(ms|us|s|m|h)", v):
        total += float(num) * {
            "us": 1e-6,
            "ms": 1e-3,
            "s": 1.0,
            "m": 60.0,
            "h": 3600.0,
        }[unit]
    return total


class Config:
    def __init__(self):
        # server/config.go NewConfig defaults :110-152
        self.data_dir = "~/.pilosa-tpu"
        self.bind = ":10101"
        self.max_writes_per_request = 5000
        self.log_path = ""
        self.verbose = False
        # cluster
        self.cluster_disabled = False
        self.cluster_coordinator = False
        self.cluster_replicas = 1
        self.cluster_hosts: List[str] = []
        self.cluster_long_query_time = 60.0
        # Replica-read routing for replicaN>1 (docs/durability.md):
        # primary | any | bounded.  ``bounded`` serves from any replica
        # heard from within freshness-ms (per-request override via
        # X-Pilosa-Freshness-Ms), skipping stale/DEAD ones.
        self.cluster_replica_read = "primary"
        self.cluster_freshness_ms = 1000.0
        # Hinted handoff (docs/durability.md): bounds on the durable
        # per-DOWN-owner replay queues.  On overflow/expiry a write
        # falls back to the pre-hint policy (additive sets skip,
        # destructive writes fail loudly).  hint-max-bytes 0 disables
        # hinting entirely.
        self.cluster_hint_max_bytes = 16 * 1024 * 1024
        self.cluster_hint_max_age = 3600.0
        # Heartbeat-recovery holddown: seconds after a failure verdict
        # before gossip liveness alone may refute it (was a hardcoded
        # 15s; docs/durability.md discusses the tradeoff).
        self.cluster_recovery_holddown_ms = 15000.0
        # gossip (SWIM membership)
        self.gossip_port = 14000
        self.gossip_seeds: List[str] = []
        self.gossip_probe_interval = 1.0
        self.gossip_probe_timeout = 0.5
        self.gossip_push_pull_interval = 30.0
        self.gossip_suspicion_mult = 4
        # anti-entropy
        self.anti_entropy_interval = 600.0
        # metrics
        self.metric_service = "none"  # statsd | expvar | none
        self.metric_host = ""
        self.metric_poll_interval = 0.0
        self.metric_diagnostics = True
        # Latest-release source for the diagnostics version check
        # (diagnostics.go:102: defaultVersionCheckURL); empty disables.
        self.diagnostics_version_url = ""
        # tracing: span tracing is always-on by default (cheap in-memory
        # span trees feeding /debug/traces); "none" opts out, "profiler"
        # additionally brackets spans with torch.profiler ranges.
        self.tracing_sampler_type = "span"  # profiler | span | none
        self.tracing_sampler_param = 0.001
        # translation
        self.translation_primary_url = ""
        # TLS (server/config.go:25-33,61): certificate/key paths enable
        # HTTPS serving; skip-verify lets cluster-internal clients accept
        # self-signed certs.
        self.tls_certificate = ""
        self.tls_key = ""
        self.tls_skip_verify = False
        # HTTP handler options (server/config.go:54-58): CORS origins.
        self.handler_allowed_origins: List[str] = []
        # Serving backend (docs/serving.md): "async" = event-loop
        # reactor (net/aserver.py), "threaded" = stdlib oracle.
        self.server_backend = "async"
        # SO_REUSEPORT acceptor/reactor workers (scale-out knob; 1 is
        # right for a single-core host).
        self.server_reactors = 1
        # Shared-nothing worker PROCESSES behind SO_REUSEPORT
        # (docs/serving.md "Process mode"): N worker processes own
        # accept/parse/decode/encode and forward decoded queries to the
        # device-owner process over AF_UNIX.  0 (default) keeps the
        # in-process reactor — byte-identical to pre-process-mode
        # behavior and the differential oracle alongside "threaded".
        self.server_workers = 0
        # Elastic blocking-route worker THREAD ceiling + bounded submit
        # queue (per process).
        self.server_pool_workers = 256
        self.server_queue_depth = 1024
        # Admission control: global in-flight bound, the load fraction
        # where per-tenant weighted fairness arms, the tenant weight map
        # ("gold=4,free=1"; unlisted tenants weigh 1).
        self.server_max_inflight = 1024
        self.server_fair_start = 0.5
        self.server_tenant_weights = ""
        # Parse-stage bounds: oversized bodies are rejected before
        # buffering; a partial request older than read-timeout is a
        # slow-loris and its connection is dropped.
        self.server_max_body_bytes = 256 * 1024 * 1024
        self.server_read_timeout = 120.0
        self.server_idle_timeout = 120.0
        # storage durability (docs/durability.md): what an ingest ack
        # promises — received | logged | fsynced.  ``logged`` (default)
        # flushes the op-log to the OS before ack, so an acked import is
        # replayable after SIGKILL by construction; ``fsynced`` survives
        # power loss; ``received`` exposes its loss window as
        # pilosa_ingest_acked_unsynced_bytes.
        self.storage_ack = "logged"
        # Parallel snapshot re-open workers at boot (warm-start); <=1
        # keeps the serial open.
        self.storage_open_workers = 4
        # Re-establish HBM residency from snapshots in the background
        # after boot, serving from the host path meanwhile (readyz
        # reports `warming` with a residency fraction until done).
        self.storage_warm_start = True
        # engine residency (docs/residency.md): the device working-set
        # budget in bytes — a SOFT target past which field stacks evict
        # (cost-priced) and cold stacks serve from the compressed host
        # tier while an async promotion admits their touched rows.
        # 0 = the engine default (parallel/engine.py DEFAULT_BUDGET_FRACTION
        # of the card's memory).
        self.engine_device_budget_bytes = 0
        # mesh (TPU-native: devices for the shard mesh; 0 = all)
        self.mesh_devices = 0
        # multi-host JAX runtime (jax.distributed): coordinator address
        # enables it; peers are the other servers' base URLs that must
        # replay collective dispatches (parallel/multihost.py).
        self.jax_coordinator = ""
        self.jax_num_processes = 0
        self.jax_process_id = 0
        self.mesh_peers: List[str] = []
        # Symmetric collective initiation: the node that issues dense
        # sequence tickets.  "self" = this node; a base URL = a peer;
        # "" = disabled (route collectives through one entry node).
        self.mesh_sequencer = ""
        # Per-peer timeout for the collective dispatch handoff: a
        # STALLED peer (frozen process, pumba-style) must fail the
        # broadcast within this bound so fused queries degrade to the
        # host path instead of hanging the dispatcher.
        self.mesh_dispatch_timeout = 30.0
        # Deterministic network-fault plane ([faults], net/faults.py):
        # rule spec strings installed at boot (tests/chaos tooling; the
        # runtime channel is POST /debug/faults) + the seed every
        # probabilistic rule draws from.
        self.faults_seed = 0
        self.faults_rules: List[str] = []
        # Self-hosted observability ([observability], docs/observability.md):
        # the history sampler writes every registry series into the internal
        # `_system` index each sample-interval, retention drops expired YMDH
        # views, and the SLO watcher evaluates burn rates over that history.
        # History is OFF by default (tests/dev opt in); the smoke lane runs
        # it at 1s.
        self.obs_history = False
        self.obs_sample_interval = 10.0
        self.obs_retention = 3600.0
        # SLO targets — 0 disables the respective objective.  error-rate is
        # a fraction of requests (5xx / all); latency-p95-ms a millisecond
        # bound on the query p95.  A burn fires when the observed value
        # exceeds target * burn-threshold sustained over slo-window.
        self.obs_slo_error_rate = 0.0
        self.obs_slo_latency_p95_ms = 0.0
        self.obs_slo_window = 300.0
        self.obs_slo_burn_threshold = 2.0
        # Flight-recorder bundles persisted to <data-dir>/.flightrec/ on a
        # burn trigger; oldest pruned past this count.
        self.obs_flightrec_max_bundles = 8

    # -- loading -----------------------------------------------------------

    def load_file(self, path: str):
        with open(path, "rb") as f:
            self.apply_dict(tomllib.load(f))

    def apply_dict(self, doc: dict):
        self.data_dir = doc.get("data-dir", self.data_dir)
        self.bind = doc.get("bind", self.bind)
        self.max_writes_per_request = doc.get(
            "max-writes-per-request", self.max_writes_per_request
        )
        self.log_path = doc.get("log-path", self.log_path)
        self.verbose = doc.get("verbose", self.verbose)
        cl = doc.get("cluster", {})
        self.cluster_disabled = cl.get("disabled", self.cluster_disabled)
        self.cluster_coordinator = cl.get("coordinator", self.cluster_coordinator)
        self.cluster_replicas = cl.get("replicas", self.cluster_replicas)
        self.cluster_hosts = cl.get("hosts", self.cluster_hosts)
        if "long-query-time" in cl:
            self.cluster_long_query_time = _parse_duration(cl["long-query-time"])
        self.cluster_replica_read = cl.get(
            "replica-read", self.cluster_replica_read
        )
        if "freshness-ms" in cl:
            self.cluster_freshness_ms = float(cl["freshness-ms"])
        if "hint-max-bytes" in cl:
            self.cluster_hint_max_bytes = int(cl["hint-max-bytes"])
        if "hint-max-age" in cl:
            self.cluster_hint_max_age = _parse_duration(cl["hint-max-age"])
        if "recovery-holddown-ms" in cl:
            self.cluster_recovery_holddown_ms = float(
                cl["recovery-holddown-ms"]
            )
        g = doc.get("gossip", {})
        self.gossip_port = int(g.get("port", self.gossip_port))
        self.gossip_seeds = g.get("seeds", self.gossip_seeds)
        if "probe-interval" in g:
            self.gossip_probe_interval = _parse_duration(g["probe-interval"])
        if "probe-timeout" in g:
            self.gossip_probe_timeout = _parse_duration(g["probe-timeout"])
        if "push-pull-interval" in g:
            self.gossip_push_pull_interval = _parse_duration(
                g["push-pull-interval"]
            )
        self.gossip_suspicion_mult = g.get(
            "suspicion-mult", self.gossip_suspicion_mult
        )
        ae = doc.get("anti-entropy", {})
        if "interval" in ae:
            self.anti_entropy_interval = _parse_duration(ae["interval"])
        m = doc.get("metric", {})
        self.metric_service = m.get("service", self.metric_service)
        self.metric_host = m.get("host", self.metric_host)
        if "poll-interval" in m:
            self.metric_poll_interval = _parse_duration(m["poll-interval"])
        self.metric_diagnostics = m.get("diagnostics", self.metric_diagnostics)
        self.diagnostics_version_url = m.get(
            "version-check-url", self.diagnostics_version_url
        )
        t = doc.get("tracing", {})
        self.tracing_sampler_type = t.get("sampler-type", self.tracing_sampler_type)
        self.tracing_sampler_param = t.get(
            "sampler-param", self.tracing_sampler_param
        )
        tr = doc.get("translation", {})
        self.translation_primary_url = tr.get(
            "primary-url", self.translation_primary_url
        )
        tls = doc.get("tls", {})
        self.tls_certificate = tls.get("certificate", self.tls_certificate)
        self.tls_key = tls.get("key", self.tls_key)
        self.tls_skip_verify = tls.get("skip-verify", self.tls_skip_verify)
        h = doc.get("handler", {})
        self.handler_allowed_origins = h.get(
            "allowed-origins", self.handler_allowed_origins
        )
        srv = doc.get("server", {})
        self.server_backend = srv.get("backend", self.server_backend)
        self.server_reactors = int(srv.get("reactors", self.server_reactors))
        self.server_workers = int(srv.get("workers", self.server_workers))
        self.server_pool_workers = int(
            srv.get("pool-workers", self.server_pool_workers)
        )
        self.server_queue_depth = int(
            srv.get("queue-depth", self.server_queue_depth)
        )
        self.server_max_inflight = int(
            srv.get("max-inflight", self.server_max_inflight)
        )
        self.server_fair_start = float(
            srv.get("fair-start", self.server_fair_start)
        )
        self.server_tenant_weights = srv.get(
            "tenant-weights", self.server_tenant_weights
        )
        self.server_max_body_bytes = int(
            srv.get("max-body-bytes", self.server_max_body_bytes)
        )
        if "read-timeout" in srv:
            self.server_read_timeout = _parse_duration(srv["read-timeout"])
        if "idle-timeout" in srv:
            self.server_idle_timeout = _parse_duration(srv["idle-timeout"])
        st = doc.get("storage", {})
        self.storage_ack = st.get("ack", self.storage_ack)
        self.storage_open_workers = int(
            st.get("open-workers", self.storage_open_workers)
        )
        self.storage_warm_start = st.get(
            "warm-start", self.storage_warm_start
        )
        eng = doc.get("engine", {})
        self.engine_device_budget_bytes = int(
            eng.get("device-budget-bytes", self.engine_device_budget_bytes)
        )
        mesh = doc.get("mesh", {})
        self.mesh_devices = mesh.get("devices", self.mesh_devices)
        # ``coordinator`` / ``processes`` / ``process-id`` are the
        # documented [mesh] keys (docs/mesh.md); the jax-* spellings are
        # kept as accepted aliases for configs written before them.
        self.jax_coordinator = mesh.get(
            "coordinator", mesh.get("jax-coordinator", self.jax_coordinator)
        )
        self.jax_num_processes = mesh.get(
            "processes", mesh.get("jax-num-processes", self.jax_num_processes)
        )
        self.jax_process_id = mesh.get(
            "process-id", mesh.get("jax-process-id", self.jax_process_id)
        )
        self.mesh_peers = mesh.get("peers", self.mesh_peers)
        self.mesh_sequencer = mesh.get("sequencer", self.mesh_sequencer)
        if "dispatch-timeout" in mesh:
            self.mesh_dispatch_timeout = _parse_duration(
                mesh["dispatch-timeout"]
            )
        flt = doc.get("faults", {})
        self.faults_seed = int(flt.get("seed", self.faults_seed))
        self.faults_rules = flt.get("rules", self.faults_rules)
        obs = doc.get("observability", {})
        self.obs_history = obs.get("history", self.obs_history)
        if "sample-interval" in obs:
            self.obs_sample_interval = _parse_duration(obs["sample-interval"])
        if "history-retention" in obs:
            self.obs_retention = _parse_duration(obs["history-retention"])
        self.obs_slo_error_rate = float(
            obs.get("slo-error-rate", self.obs_slo_error_rate)
        )
        self.obs_slo_latency_p95_ms = float(
            obs.get("slo-latency-p95-ms", self.obs_slo_latency_p95_ms)
        )
        if "slo-window" in obs:
            self.obs_slo_window = _parse_duration(obs["slo-window"])
        self.obs_slo_burn_threshold = float(
            obs.get("slo-burn-threshold", self.obs_slo_burn_threshold)
        )
        self.obs_flightrec_max_bundles = int(
            obs.get("flightrec-max-bundles", self.obs_flightrec_max_bundles)
        )

    def load_env(self, environ=None):
        env = environ if environ is not None else os.environ

        def get(name, cast=str):
            v = env.get(ENV_PREFIX + name)
            if v is None:
                return None
            if cast is bool:
                return v.lower() in ("1", "true", "yes")
            if cast is list:
                return [s for s in v.split(",") if s]
            return cast(v)

        for attr, name, cast in [
            ("data_dir", "DATA_DIR", str),
            ("bind", "BIND", str),
            ("max_writes_per_request", "MAX_WRITES_PER_REQUEST", int),
            ("log_path", "LOG_PATH", str),
            ("verbose", "VERBOSE", bool),
            ("cluster_disabled", "CLUSTER_DISABLED", bool),
            ("cluster_coordinator", "CLUSTER_COORDINATOR", bool),
            ("cluster_replicas", "CLUSTER_REPLICAS", int),
            ("cluster_hosts", "CLUSTER_HOSTS", list),
            ("cluster_replica_read", "CLUSTER_REPLICA_READ", str),
            ("cluster_freshness_ms", "CLUSTER_FRESHNESS_MS", float),
            ("cluster_hint_max_bytes", "CLUSTER_HINT_MAX_BYTES", int),
            ("cluster_hint_max_age", "CLUSTER_HINT_MAX_AGE", _parse_duration),
            (
                "cluster_recovery_holddown_ms",
                "CLUSTER_RECOVERY_HOLDDOWN_MS",
                float,
            ),
            # Semicolon-separated rule specs (commas are the env list
            # separator elsewhere; fault specs never contain ';').
            ("faults_rules", "FAULTS", lambda v: [
                s.strip() for s in v.split(";") if s.strip()
            ]),
            ("faults_seed", "FAULTS_SEED", int),
            ("storage_ack", "STORAGE_ACK", str),
            ("storage_open_workers", "STORAGE_OPEN_WORKERS", int),
            ("storage_warm_start", "STORAGE_WARM_START", bool),
            ("gossip_port", "GOSSIP_PORT", int),
            ("gossip_seeds", "GOSSIP_SEEDS", list),
            ("anti_entropy_interval", "ANTI_ENTROPY_INTERVAL", _parse_duration),
            ("metric_service", "METRIC_SERVICE", str),
            ("metric_host", "METRIC_HOST", str),
            ("diagnostics_version_url", "DIAGNOSTICS_VERSION_URL", str),
            ("tracing_sampler_type", "TRACING_SAMPLER_TYPE", str),
            ("translation_primary_url", "TRANSLATION_PRIMARY_URL", str),
            ("tls_certificate", "TLS_CERTIFICATE", str),
            ("tls_key", "TLS_KEY", str),
            ("tls_skip_verify", "TLS_SKIP_VERIFY", bool),
            ("handler_allowed_origins", "HANDLER_ALLOWED_ORIGINS", list),
            ("server_backend", "SERVER_BACKEND", str),
            ("server_reactors", "SERVER_REACTORS", int),
            ("server_workers", "SERVER_WORKERS", int),
            ("server_pool_workers", "SERVER_POOL_WORKERS", int),
            ("server_queue_depth", "SUBMIT_QUEUE", int),
            ("server_max_inflight", "MAX_INFLIGHT", int),
            ("server_fair_start", "FAIR_START", float),
            ("server_tenant_weights", "TENANT_WEIGHTS", str),
            ("server_max_body_bytes", "MAX_BODY_BYTES", int),
            ("server_read_timeout", "READ_TIMEOUT", _parse_duration),
            ("server_idle_timeout", "IDLE_TIMEOUT", _parse_duration),
            ("engine_device_budget_bytes", "ENGINE_DEVICE_BUDGET_BYTES", int),
            ("mesh_devices", "MESH_DEVICES", int),
            ("jax_coordinator", "JAX_COORDINATOR", str),
            ("jax_num_processes", "JAX_NUM_PROCESSES", int),
            ("jax_process_id", "JAX_PROCESS_ID", int),
            ("mesh_peers", "MESH_PEERS", list),
            ("mesh_sequencer", "MESH_SEQUENCER", str),
            ("obs_history", "OBS_HISTORY", bool),
            ("obs_sample_interval", "OBS_SAMPLE_INTERVAL", _parse_duration),
            ("obs_retention", "OBS_HISTORY_RETENTION", _parse_duration),
            ("obs_slo_error_rate", "OBS_SLO_ERROR_RATE", float),
            ("obs_slo_latency_p95_ms", "OBS_SLO_LATENCY_P95_MS", float),
            ("obs_slo_window", "OBS_SLO_WINDOW", _parse_duration),
            ("obs_slo_burn_threshold", "OBS_SLO_BURN_THRESHOLD", float),
            (
                "obs_flightrec_max_bundles",
                "OBS_FLIGHTREC_MAX_BUNDLES",
                int,
            ),
        ]:
            v = get(name, cast)
            if v is not None:
                setattr(self, attr, v)

    # -- generation (ctl/generate_config.go) -------------------------------

    def to_toml(self) -> str:
        hosts = ", ".join(f'"{h}"' for h in self.cluster_hosts)
        seeds = ", ".join(f'"{s}"' for s in self.gossip_seeds)
        return f"""data-dir = "{self.data_dir}"
bind = "{self.bind}"
max-writes-per-request = {self.max_writes_per_request}
log-path = "{self.log_path}"
verbose = {str(self.verbose).lower()}

[cluster]
disabled = {str(self.cluster_disabled).lower()}
coordinator = {str(self.cluster_coordinator).lower()}
replicas = {self.cluster_replicas}
hosts = [{hosts}]
long-query-time = "{int(self.cluster_long_query_time)}s"
replica-read = "{self.cluster_replica_read}"
freshness-ms = {self.cluster_freshness_ms}
hint-max-bytes = {self.cluster_hint_max_bytes}
hint-max-age = "{int(self.cluster_hint_max_age)}s"
recovery-holddown-ms = {self.cluster_recovery_holddown_ms}

[gossip]
port = {self.gossip_port}
seeds = [{seeds}]
probe-interval = "{self.gossip_probe_interval}s"
probe-timeout = "{self.gossip_probe_timeout}s"
push-pull-interval = "{self.gossip_push_pull_interval}s"
suspicion-mult = {self.gossip_suspicion_mult}

[anti-entropy]
interval = "{int(self.anti_entropy_interval)}s"

[metric]
service = "{self.metric_service}"
host = "{self.metric_host}"
poll-interval = "{int(self.metric_poll_interval)}s"
diagnostics = {str(self.metric_diagnostics).lower()}

[tracing]
sampler-type = "{self.tracing_sampler_type}"
sampler-param = {self.tracing_sampler_param}

[tls]
certificate = "{self.tls_certificate}"
key = "{self.tls_key}"
skip-verify = {str(self.tls_skip_verify).lower()}

[handler]
allowed-origins = [{", ".join(f'"{o}"' for o in self.handler_allowed_origins)}]

[server]
backend = "{self.server_backend}"
reactors = {self.server_reactors}
workers = {self.server_workers}
pool-workers = {self.server_pool_workers}
queue-depth = {self.server_queue_depth}
max-inflight = {self.server_max_inflight}
fair-start = {self.server_fair_start}
tenant-weights = "{self.server_tenant_weights}"
max-body-bytes = {self.server_max_body_bytes}
read-timeout = "{int(self.server_read_timeout)}s"
idle-timeout = "{int(self.server_idle_timeout)}s"

[storage]
ack = "{self.storage_ack}"
open-workers = {self.storage_open_workers}
warm-start = {str(self.storage_warm_start).lower()}

[translation]
primary-url = "{self.translation_primary_url}"

[engine]
device-budget-bytes = {self.engine_device_budget_bytes}

[mesh]
devices = {self.mesh_devices}
coordinator = "{self.jax_coordinator}"
processes = {self.jax_num_processes}
process-id = {self.jax_process_id}
peers = [{", ".join(f'"{u}"' for u in self.mesh_peers)}]
sequencer = "{self.mesh_sequencer}"

[observability]
history = {str(self.obs_history).lower()}
sample-interval = "{int(self.obs_sample_interval)}s"
history-retention = "{int(self.obs_retention)}s"
slo-error-rate = {self.obs_slo_error_rate}
slo-latency-p95-ms = {self.obs_slo_latency_p95_ms}
slo-window = "{int(self.obs_slo_window)}s"
slo-burn-threshold = {self.obs_slo_burn_threshold}
flightrec-max-bundles = {self.obs_flightrec_max_bundles}
"""

    def bind_host_port(self):
        host, _, port = self.bind.rpartition(":")
        return host or "0.0.0.0", int(port or 10101)

