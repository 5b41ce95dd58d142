"""Cluster: membership + shard placement + elastic resize.

Mirror of the reference's cluster (cluster.go:172-2042):

- Placement: partition = fnv1a64(index || shard_be8) % 256
  (cluster.go partition :828-838), primary node = jump-consistent-hash
  of the partition over the sorted node list (jmphasher :905-913),
  replicas = the next replicaN-1 nodes around the ring
  (partitionNodes :857-878).
- States STARTING / NORMAL / DEGRADED / RESIZING (cluster.go:44-49),
  DEGRADED when fewer than replicaN-1 extra nodes are lost
  (determineClusterState :522).
- Membership changes arrive as join/leave events (from gossip or admin
  RPC, cluster.go ReceiveEvent :1658-1818); the coordinator builds a
  resize job diffing old/new fragment placement (fragSources :741-826,
  resizeJob :1383-1497) and nodes fetch missing shards over the data
  plane (followResizeInstruction :1251-1347).
- Topology persisted to ``.topology`` (cluster.go:1593-1628).

A copy of ``pilosa_tpu/cluster/cluster.py``: the host control plane that
places shards on nodes and streams fragments between them.  Each node's
queries run on its own card; a node's ``devices`` weight is 1 for one card.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..util import events as events_mod

DEFAULT_PARTITION_N = 256

STATE_STARTING = "STARTING"
STATE_NORMAL = "NORMAL"
STATE_DEGRADED = "DEGRADED"
STATE_RESIZING = "RESIZING"


def fnv1a64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def jump_hash(key: int, n: int) -> int:
    """Jump consistent hash (cluster.go jmphasher :905-913)."""
    b, j = -1, 0
    key &= 0xFFFFFFFFFFFFFFFF
    while j < n:
        b = j
        key = (key * 2862933555777941757 + 1) & 0xFFFFFFFFFFFFFFFF
        j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


class Node:
    __slots__ = ("id", "uri", "is_coordinator", "state", "devices")

    def __init__(
        self,
        id: str,
        uri: str,
        is_coordinator: bool = False,
        devices: int = 1,
    ):
        self.id = id
        self.uri = uri
        self.is_coordinator = is_coordinator
        self.state = "READY"
        # Placement weight = the node's accelerator count (node = mesh):
        # an 8-chip host owns 8x the partition slots of a 1-chip host, so
        # its in-mesh psum reduce covers 8x the shards with zero network
        # hops (docs/mesh.md).  Advertised via gossip node metadata.
        self.devices = max(1, int(devices))

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "uri": self.uri,
            "isCoordinator": self.is_coordinator,
            "state": self.state,
            "devices": self.devices,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        n = cls(
            d["id"], d["uri"], d.get("isCoordinator", False),
            devices=d.get("devices", 1),
        )
        n.state = d.get("state", "READY")
        return n

    def clone(self) -> "Node":
        """Value copy for placement diffs: frag_sources must compute the
        OLD placement from pre-change weights even after the live Node
        object is updated in place."""
        n = Node(self.id, self.uri, self.is_coordinator, self.devices)
        n.state = self.state
        return n

    def __repr__(self):
        return f"Node({self.id}@{self.uri}x{self.devices})"


def place_partition(
    nodes: List["Node"], replica_n: int, partition_id: int
) -> List["Node"]:
    """Capacity-weighted partition placement: the single source of
    placement truth, used by live routing (partition_nodes) AND resize
    diffing (frag_sources) so the two can never diverge.

    Each node contributes ``devices`` slots to a ring ordered by node id;
    the primary is ``jump_hash(partition, total_slots)`` and replicas are
    the next DISTINCT nodes around the ring.  With every weight at 1 this
    degrades exactly to the reference's scheme (jump_hash over the sorted
    node list, replicas adjacent — cluster.go jmphasher :905,
    partitionNodes :857), so homogeneous clusters keep byte-identical
    placement across the upgrade."""
    slots, n_nodes = build_slot_ring(nodes)
    return place_on_ring(slots, n_nodes, replica_n, partition_id)


def build_slot_ring(nodes: List["Node"]) -> Tuple[List["Node"], int]:
    """(slot ring, distinct node count): each node repeated ``devices``
    times in id order.  O(total devices) — hot callers (per-shard
    routing) cache the ring per membership/weight epoch
    (Cluster._placement_ring) instead of rebuilding it per shard."""
    ordered = sorted(nodes, key=lambda n: n.id)
    slots: List[Node] = []
    for n in ordered:
        slots.extend([n] * max(1, getattr(n, "devices", 1)))
    return slots, len(ordered)


def place_on_ring(
    slots: List["Node"], n_nodes: int, replica_n: int, partition_id: int
) -> List["Node"]:
    if not slots:
        return []
    start = jump_hash(partition_id, len(slots))
    out: List[Node] = []
    seen = set()
    for i in range(len(slots)):
        n = slots[(start + i) % len(slots)]
        if n.id in seen:
            continue
        out.append(n)
        seen.add(n.id)
        if len(out) >= min(replica_n, n_nodes):
            break
    return out


RESIZE_JOB_RUNNING = "RUNNING"
RESIZE_JOB_DONE = "DONE"
RESIZE_JOB_ABORTED = "ABORTED"
# A join/leave arrived while another job was active: the action was
# QUEUED for replay when the running job finishes (not silently dropped).
RESIZE_JOB_QUEUED = "QUEUED"


class ResizeJob:
    """Coordinator-tracked resize job (cluster.go resizeJob :1383-1497):
    a random job ID, per-node completion flags, and a terminal state the
    coordinator waits on.  Nodes run their instructions asynchronously
    and report back with ``resize-complete`` messages; a
    reported error — or an explicit abort — terminates the job as
    ABORTED, and the coordinator never flips the cluster back to NORMAL
    silently while instructions are outstanding."""

    __slots__ = ("id", "action", "pending", "instructions", "state",
                 "error", "_done", "_mu")

    def __init__(self, node_ids: List[str], action: str):
        self.id = random.getrandbits(63)
        self.action = action
        # node id -> completed?  (resizeJob.IDs, cluster.go:1392)
        self.pending: Dict[str, bool] = {nid: False for nid in node_ids}
        self.instructions: List[dict] = []
        self.state = RESIZE_JOB_RUNNING
        self.error: Optional[str] = None
        self._done = threading.Event()
        self._mu = threading.Lock()

    def mark_node_complete(self, node_id: str, error: str = ""):
        """markResizeInstructionComplete (cluster.go:1349-1372)."""
        with self._mu:
            if self.state != RESIZE_JOB_RUNNING:
                return
            if error:
                self.error = f"{node_id}: {error}"
                self.state = RESIZE_JOB_ABORTED
                self._done.set()
                return
            self.pending[node_id] = True
            if all(self.pending.values()):
                self.state = RESIZE_JOB_DONE
                self._done.set()

    def abort(self, reason: str = "aborted"):
        with self._mu:
            if self.state == RESIZE_JOB_RUNNING:
                self.state = RESIZE_JOB_ABORTED
                self.error = reason
                self._done.set()

    def wait(self, timeout: Optional[float]) -> str:
        if not self._done.wait(timeout):
            self.abort(f"timed out after {timeout}s")
        return self.state

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "action": self.action,
            "state": self.state,
            "error": self.error,
            "pending": sorted(
                nid for nid, done in self.pending.items() if not done
            ),
        }


class ResizeSource:
    """One fragment to fetch during a resize (internal ResizeSource)."""

    __slots__ = ("node", "index", "field", "view", "shard")

    def __init__(self, node: Node, index: str, field: str, view: str, shard: int):
        self.node = node
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard

    def __repr__(self):
        return (
            f"ResizeSource({self.index}/{self.field}/{self.view}/{self.shard}"
            f" from {self.node.id})"
        )


class Cluster:
    def __init__(
        self,
        node: Node,
        replica_n: int = 1,
        partition_n: int = DEFAULT_PARTITION_N,
        hosts: Optional[List[str]] = None,
        path: Optional[str] = None,
        client_factory: Optional[Callable[[str], object]] = None,
        logger=None,
        journal=None,
    ):
        self.node = node
        self.replica_n = max(replica_n, 1)
        self.partition_n = partition_n
        self.path = path
        self.state = STATE_STARTING
        # Replica-read routing policy ([cluster] replica-read,
        # docs/durability.md): how the executor's shard mapper picks
        # among a shard's owners for READ calls.
        #   primary — the first live owner in replica order (the
        #             reference's behavior, plus proactive DOWN skip)
        #   any     — deterministic spread across all live owners
        #             (read scaling: replicaN>1 serves reads, not just
        #             failover)
        #   bounded — spread, but only over replicas whose heartbeat is
        #             within ``freshness_ms`` (per-request override via
        #             X-Pilosa-Freshness-Ms); stale replicas are skipped
        #             and the primary is the fallback.
        self.replica_read = "primary"
        self.freshness_ms = 1000.0
        # node id -> (monotonic receipt time, per-index version tokens):
        # refreshed by gossip liveness confirmations and NodeStatus
        # exchanges (which carry holder.data_versions()).  The bounded
        # replica-read mode reads this; missing entries mean "stale".
        self._heartbeats: Dict[str, tuple] = {}
        # Bounded-read quarantine: a node that was marked DOWN may have
        # missed writes, and mere liveness does not heal them — only a
        # completed anti-entropy pass does.  node id -> the peer's
        # aePasses counter at first post-recovery heartbeat (None until
        # one arrives); released when the counter ADVANCES past that
        # baseline, i.e. a full pass started after recovery finished.
        self._read_quarantine: Dict[str, Optional[int]] = {}
        # Completed error-free anti-entropy passes on THIS node,
        # bumped by HolderSyncer and advertised in node_status() so
        # peers can release their quarantine of us.
        self.ae_passes = 0
        # node id -> monotonic time of its most recent failure verdict:
        # heartbeat-driven recovery honors a holddown from this stamp
        # (see note_heartbeat), so a node whose gossip is alive but
        # whose SERVING plane keeps failing RPCs stays DOWN between
        # verdicts instead of flapping back per datagram.
        self._down_since: Dict[str, float] = {}
        # Heartbeat-recovery holddown, seconds ([cluster]
        # recovery-holddown-ms, docs/durability.md): instance-level so
        # the Server can wire the configured value; the class constant
        # stays the documented default.
        self.recovery_holddown = self.RECOVERY_HOLDDOWN
        # Hinted handoff (docs/durability.md): the HintManager attached
        # by the Server (None = pre-hint skip-or-fail-loud policy only —
        # the harness default, so failure-policy tests keep their exact
        # pre-hint semantics unless they opt in).
        self.hints = None
        # Peer-advertised pending-hint counts: advertiser node id ->
        # (monotonic receipt stamp, {target node id: records}), learned
        # from NodeStatus exchanges ("pendingHints").  Quarantine
        # release consults this — a recovered node stays quarantined
        # while ANY peer still holds un-replayed hints for it, not just
        # while WE do.  Entries expire at PEER_HINTS_TTL (see
        # hints_pending_for): an advertiser that died PERMANENTLY
        # (never admin-removed) must not wedge its target's quarantine
        # and anti-entropy forever on a stale advertisement.
        self._peer_hints: Dict[str, tuple] = {}
        self.nodes: List[Node] = [node]
        self._lock = threading.RLock()
        self.logger = logger
        # Structured event journal: cluster state transitions and resize
        # job phases append here (/debug/events?type=cluster).
        self.journal = journal if journal is not None else events_mod.JOURNAL
        self.holder = None  # attached by the server/harness
        # Gossip-piggyback hook for SendAsync (set by server._setup_gossip).
        self.gossip_send_async = None
        if client_factory is None:
            from ..net import InternalClient

            client_factory = InternalClient
        self._client_factory = client_factory
        self._clients: Dict[str, object] = {}
        # (membership key, slot ring, node count): see _placement_ring.
        self._ring_cache: Optional[tuple] = None
        self.hosts = hosts or []
        self.event_listeners: List[Callable] = []
        # Resize-job bookkeeping (cluster.go jobs/currentJob :188-190).
        self.jobs: Dict[int, ResizeJob] = {}
        self.current_job: Optional[ResizeJob] = None
        # Join/leave actions that arrived during an active resize job,
        # replayed when it finishes (("join", Node) / ("leave", id)).
        self._pending_node_actions: List[tuple] = []
        self.load_topology()

    # -- clients -----------------------------------------------------------

    def client(self, node: Node):
        c = self._clients.get(node.uri)
        if c is None:
            c = self._client_factory(node.uri)
            self._clients[node.uri] = c
        return c

    # -- placement (cluster.go :828-913) -----------------------------------

    def partition(self, index: str, shard: int) -> int:
        data = index.encode() + shard.to_bytes(8, "big")
        return fnv1a64(data) % self.partition_n

    def _placement_ring(self) -> Tuple[List[Node], int]:
        """Cached weighted slot ring (caller holds self._lock).  Keyed
        on the (id, devices) multiset so direct test mutations of
        ``nodes``/``devices`` invalidate it too — per-shard routing
        calls this once per shard per query, and rebuilding the ring
        (sort + total-devices slot list) there measurably taxed
        1000-shard fan-outs."""
        key = tuple(sorted((n.id, n.devices) for n in self.nodes))
        cached = self._ring_cache
        if cached is not None and cached[0] == key:
            return cached[1], cached[2]
        slots, n_nodes = build_slot_ring(self.nodes)
        # The ring's per-shard owners, filled by shard_nodes.
        self._ring_cache = (key, slots, n_nodes, {})
        return slots, n_nodes

    def partition_nodes(self, partition_id: int) -> List[Node]:
        with self._lock:
            slots, n_nodes = self._placement_ring()
            return place_on_ring(slots, n_nodes, self.replica_n, partition_id)

    # Owner lists kept per ring (shard_nodes); past this many the cache
    # starts over.
    SHARD_NODES_CACHE_MAX = 1 << 16

    def shard_nodes(self, index: str, shard: int) -> List[Node]:
        """The shard's owners, primary first (``owners_of`` of one)."""
        return self.owners_of(index, (shard,))[0]

    def owners_of(self, index: str, shards) -> List[List[Node]]:
        """Each shard's owners, primary first, under one lock and one ring.
        Cached per (index, shard) with the slot ring they were placed on: a
        query over 960 shards asks for each shard's owners two or three
        times (the local subset, the mapper's routing), and the fnv and
        jump hashes in Python cost about 7 ms a 960-shard pass."""
        with self._lock:
            slots, n_nodes = self._placement_ring()
            owners_by = self._ring_cache[3]
            if len(owners_by) >= self.SHARD_NODES_CACHE_MAX:
                owners_by.clear()
            out = []
            for shard in shards:
                key = (index, shard, self.replica_n, self.partition_n)
                owners = owners_by.get(key)
                if owners is None:
                    owners = owners_by[key] = place_on_ring(
                        slots, n_nodes, self.replica_n, self.partition(index, shard))
                out.append(list(owners))
            return out

    def owns_shard(self, node_id: str, index: str, shard: int) -> bool:
        return any(n.id == node_id for n in self.shard_nodes(index, shard))

    def primary_shard_node(self, index: str, shard: int) -> Node:
        return self.shard_nodes(index, shard)[0]

    def shards_by_node(
        self, index: str, shards: List[int]
    ) -> Dict[str, List[int]]:
        """Assign each shard to one owner, preferring this node (the
        reference's mapper assignment, executor.go:2245-2281)."""
        out: Dict[str, List[int]] = {}
        for s in shards:
            owners = self.shard_nodes(index, s)
            target = next(
                (n for n in owners if n.id == self.node.id), owners[0]
            )
            out.setdefault(target.id, []).append(s)
        return out

    def node_by_id(self, node_id: str) -> Optional[Node]:
        with self._lock:
            for n in self.nodes:
                if n.id == node_id:
                    return n
        return None

    def coordinator(self) -> Optional[Node]:
        with self._lock:
            for n in self.nodes:
                if n.is_coordinator:
                    return n
        return None

    def is_coordinator(self) -> bool:
        return self.node.is_coordinator

    # -- membership (cluster.go ReceiveEvent :1658-1818) -------------------

    def _sort_nodes(self):
        self.nodes.sort(key=lambda n: n.id)

    def add_node(self, node: Node, resize: bool = True):
        """Node join: re-place fragments when data exists (nodeJoin
        :1697)."""
        with self._lock:
            existing = next((n for n in self.nodes if n.id == node.id), None)
            if existing is not None:
                # A KNOWN node (re)joining — e.g. peers restored from a
                # persisted topology before they actually came back — is
                # a recovery signal: refresh its state and re-run the
                # state machine, or a restarted coordinator would report
                # STARTING forever while every peer is healthy.
                reweigh = existing.devices != node.devices
                changed = (
                    existing.state != node.state or existing.uri != node.uri
                )
                existing.state = node.state
                existing.uri = node.uri
                if changed:
                    # A rejoin may carry a NEW address: persist it NOW,
                    # unconditionally — a device-count change rides a
                    # resize job below and only lands on success, but a
                    # URI must survive a coordinator restart even if
                    # that job aborts (or the address routes fragments
                    # to a dead socket after recovery).
                    self.save_topology()
                if not reweigh:
                    self._determine_state()
                    return
                # A device-count change (host re-provisioned with a
                # different chip count) moves partition slots, so the
                # placement diff must be walked like a membership
                # change — below, outside the lock.
            old_nodes = list(self.nodes)

        if existing is not None:
            self._reweigh_node(existing, node.devices, resize)
            return

        def apply_membership():
            with self._lock:
                if any(n.id == node.id for n in self.nodes):
                    return
                self.nodes.append(node)
                self._sort_nodes()
                self.save_topology()
            self._emit("join", node)
            # Routing convergence: every member (incl. the joiner)
            # learns per-field available shards (NodeStatus exchange).
            if self.is_coordinator() and self.holder is not None:
                self.send_sync(self.node_status())

        # With data on a coordinator, the membership change lands ONLY
        # after the resize job completes (handleNodeAction
        # cluster.go:1048-1061: addNode on resizeJobStateDone): queries
        # keep routing on the OLD topology while fragments move, and an
        # aborted job leaves the joiner out of the cluster entirely.
        # On success the closure runs INSIDE the job, before the
        # cluster leaves RESIZING (see _run_resize on the lost-write
        # window); a concurrent job queues the join for replay.
        if (
            resize
            and self.is_coordinator()
            and self.holder is not None
            and self.holder.has_data()
        ):
            new_nodes = sorted(old_nodes + [node], key=lambda n: n.id)
            self._run_resize(
                old_nodes, new_nodes, apply_membership, action=("join", node)
            )
            self._determine_state()
            return
        apply_membership()
        self._determine_state()

    def remove_node(self, node_id: str, resize: bool = True) -> Optional[Node]:
        with self._lock:
            node = self.node_by_id(node_id)
            if node is None:
                return None
            old_nodes = list(self.nodes)

        def apply_membership():
            with self._lock:
                self.nodes = [n for n in self.nodes if n.id != node_id]
                self.save_topology()
            self._heartbeats.pop(node_id, None)
            self._read_quarantine.pop(node_id, None)
            self._peer_hints.pop(node_id, None)
            if self.hints is not None:
                # An admin-removed node never replays: its queued hints
                # are dropped (reason=node_removed), counted + journaled.
                self.hints.drop_node(node_id)
            self._emit("leave", node)
            if self.is_coordinator() and self.holder is not None:
                self.send_sync(self.node_status())

        # Same job-then-membership order as add_node (cluster.go:1052:
        # removeNode only on resizeJobStateDone); on success the
        # membership applies before the cluster leaves RESIZING.
        if (
            resize
            and self.is_coordinator()
            and self.holder is not None
            and self.holder.has_data()  # cluster.go:1747
        ):
            new_nodes = [n for n in old_nodes if n.id != node_id]
            state = self._run_resize(
                old_nodes, new_nodes, apply_membership,
                action=("leave", node_id),
            )
            if state != RESIZE_JOB_DONE:
                self._determine_state()
                # Distinct from the None "node not found" answer: the
                # node is STILL a member; the admin must see the failed
                # (or queued-behind-another-job) outcome, not a
                # success-shaped null.
                raise RuntimeError(
                    f"resize job queued; node {node_id!r} will be removed "
                    "when the running job finishes"
                    if state == RESIZE_JOB_QUEUED
                    else f"resize job aborted; node {node_id!r} not removed"
                )
            self._determine_state()
            return node
        apply_membership()
        self._determine_state()
        return node

    def _reweigh_node(self, existing: Node, devices: int, resize: bool = True):
        """A known node re-announced itself with a DIFFERENT device count
        (host re-provisioned from 1 chip to 8, or vice versa).  Placement
        weight changes move partition slots exactly like membership
        changes do, so with data on a coordinator the weight lands only
        after a resize job has moved the affected fragments — queries
        keep routing on the old weights while data is in flight."""
        with self._lock:
            old_nodes = [n.clone() for n in self.nodes]
            new_nodes = [n.clone() for n in self.nodes]
            for n in new_nodes:
                if n.id == existing.id:
                    n.devices = max(1, int(devices))

        def apply_membership():
            with self._lock:
                existing.devices = max(1, int(devices))
                self.save_topology()
            if self.is_coordinator() and self.holder is not None:
                self.send_sync(self.node_status())

        if (
            resize
            and self.is_coordinator()
            and self.holder is not None
            and self.holder.has_data()
        ):
            self._run_resize(
                old_nodes, new_nodes, apply_membership,
                action=("reweigh", (existing.id, devices)),
            )
            self._determine_state()
            return
        apply_membership()
        self._determine_state()

    # -- replica freshness (docs/durability.md) ----------------------------

    # Seconds after a failure verdict before a gossip heartbeat alone
    # may refute it (membership-observed restarts bypass this).
    RECOVERY_HOLDDOWN = 15.0

    def note_heartbeat(
        self,
        node_id: str,
        versions: Optional[dict] = None,
        ae_passes: Optional[int] = None,
        pending_hints: Optional[dict] = None,
    ):
        """Record liveness evidence about a peer: a gossip probe ack /
        ALIVE update (``versions`` None) or a NodeStatus exchange
        carrying its per-index data-version tokens and anti-entropy
        pass counter.  A version-less heartbeat keeps the previous
        tokens.

        Direct contact also REFUTES a stale failure verdict: one timed-
        out RPC marks a peer DOWN (executor hedging), and without this
        a healthy-but-blipped node would stay DOWN — skipped by reads
        AND writes — until a membership event happened to refresh it.
        Recovery waits out RECOVERY_HOLDDOWN from the LAST verdict:
        gossip liveness is not proof the serving plane works (a node
        with a wedged HTTP acceptor still answers probes), so each
        fresh RPC failure re-arms the holddown and the node stays
        skipped between verdicts instead of flapping back per datagram
        and stalling a query per flap.  A true gossip-observed restart
        recovers immediately via the membership path (add_node on
        dead->alive).  The bounded-read quarantine below still holds
        until anti-entropy actually heals whatever the node missed."""
        if node_id == self.node.id:
            return
        now = time.monotonic()
        prev = self._heartbeats.get(node_id)
        if versions is None and prev is not None:
            versions = prev[1]
        self._heartbeats[node_id] = (now, versions or {})
        if pending_hints is not None:
            # The advertiser's full pending-hint map replaces its
            # previous advertisement (an empty map clears it — that is
            # the "my hints for X drained" signal quarantine waits on).
            self._peer_hints[node_id] = (now, {
                str(t): int(n) for t, n in pending_hints.items() if int(n)
            })
        n = self.node_by_id(node_id)
        if (
            n is not None
            and n.state == "DOWN"
            and now - self._down_since.get(node_id, 0.0)
            >= self.recovery_holddown
        ):
            self.node_recovered(node_id)
        if node_id in self._read_quarantine and ae_passes is not None:
            base = self._read_quarantine[node_id]
            if base is None:
                self._read_quarantine[node_id] = int(ae_passes)
            elif int(ae_passes) > base:
                # A whole pass completed strictly after recovery: every
                # shard the peer owns has been reconciled against its
                # replicas — bounded reads may trust it again... UNLESS
                # pending hints for it are still queued anywhere
                # (locally or peer-advertised): the replay must land
                # BEFORE readmission, or a bounded read could serve a
                # bit whose queued clear hasn't reached the node yet
                # (replay-before-quarantine ordering,
                # docs/durability.md "Hinted handoff").
                if self.hints_pending_for(node_id) == 0:
                    del self._read_quarantine[node_id]
                    self.journal.append(
                        "cluster.quarantine.release", node=node_id,
                        aePasses=int(ae_passes),
                    )

    # How long a peer's pending-hint advertisement stays trusted
    # without a refresh.  Advertisements re-send with every NodeStatus
    # (each anti-entropy interval at minimum, default 600 s), so a live
    # advertiser refreshes well inside the TTL — only a PERMANENTLY
    # dead one (crashed, never admin-removed) goes stale, and its
    # target must not be quarantined/AE-deferred forever on its ghost.
    PEER_HINTS_TTL = 30 * 60.0

    def hints_pending_for(self, node_id: str) -> int:
        """Known un-replayed hints targeting ``node_id``, summed over
        this node's own queue and every peer's latest (unexpired)
        advertisement — the replay-before-readmission gate for
        bounded-read quarantine AND the syncer's defer-own-AE-pass
        check."""
        total = 0
        if self.hints is not None:
            total += self.hints.pending(node_id)
        now = time.monotonic()
        for advertiser, (stamp, targets) in list(self._peer_hints.items()):
            if advertiser == self.node.id:
                continue
            if now - stamp > self.PEER_HINTS_TTL:
                del self._peer_hints[advertiser]
                continue
            total += int(targets.get(node_id, 0))
        return total

    def heartbeat_age_ms(self, node_id: str) -> Optional[float]:
        """Milliseconds since the last heartbeat from ``node_id``;
        None when nothing has ever been heard (treated as stale)."""
        hb = self._heartbeats.get(node_id)
        if hb is None:
            return None
        return (time.monotonic() - hb[0]) * 1000.0

    def peer_versions(self, node_id: str) -> dict:
        hb = self._heartbeats.get(node_id)
        return hb[1] if hb is not None else {}

    def replica_fresh(
        self, node_id: str, index: str, freshness_ms: float
    ) -> bool:
        """Is ``node_id`` an acceptable BOUNDED-read target?  Fresh =
        marked READY and heard from within the bound.  Why liveness is
        the right staleness proxy here: replicated writes apply to every
        owner synchronously before ack, so a replica alive throughout
        the last F ms has every write acked in that window; divergence
        only accumulates while a replica is dead — and a failure verdict
        CLEARS its heartbeat entry (node_failed), so a recovering node
        stays stale until fresh evidence arrives.  Per-index version
        tokens ride the same heartbeats for observability (/debug/vars
        clusterHeartbeats) — they are per-node mutation counters, not
        comparable across nodes, so they don't gate routing.  This node
        is always fresh (read-your-writes)."""
        if node_id == self.node.id:
            return True
        n = self.node_by_id(node_id)
        if n is not None and n.state == "DOWN":
            return False
        if node_id in self._read_quarantine:
            # Recovered but not yet healed: liveness resumed, but the
            # writes it missed while DOWN are only repaired by a full
            # anti-entropy pass — until then its answers can be staler
            # than ANY requested bound.
            return False
        age = self.heartbeat_age_ms(node_id)
        return age is not None and age <= freshness_ms

    def heartbeats(self) -> dict:
        """Introspection snapshot for /debug/vars: per-peer heartbeat
        age, version tokens, and the bounded-read quarantine flag."""
        out = {}
        for nid, (t, vs) in list(self._heartbeats.items()):
            out[nid] = {
                "ageMs": round((time.monotonic() - t) * 1000.0, 1),
                "versions": dict(vs),
                "quarantined": nid in self._read_quarantine,
            }
        for nid in list(self._read_quarantine):
            out.setdefault(nid, {"quarantined": True})
        for nid, entry in out.items():
            if entry.get("quarantined"):
                # WHY the node is still quarantined: un-replayed hints
                # block readmission even after anti-entropy advances.
                entry["hintsPending"] = self.hints_pending_for(nid)
        return out

    def node_failed(self, node_id: str):
        """Failure detector verdict (gossip NotifyLeave): mark and degrade;
        data is NOT re-placed until an admin removes the node
        (cluster.go nodeLeave :1733).  The heartbeat entry is cleared so
        bounded replica reads treat the node as stale until fresh
        evidence arrives post-recovery."""
        node = self.node_by_id(node_id)
        if node is not None:
            node.state = "DOWN"
        self._heartbeats.pop(node_id, None)
        # Bounded reads distrust the node past its recovery, until a
        # post-recovery anti-entropy pass completes (see note_heartbeat).
        self._read_quarantine[node_id] = None
        # Re-arm the heartbeat-recovery holddown: repeated RPC failures
        # keep the node DOWN even while its gossip stays chatty.
        self._down_since[node_id] = time.monotonic()
        self._determine_state()

    def node_recovered(self, node_id: str):
        node = self.node_by_id(node_id)
        if node is not None:
            node.state = "READY"
        self._determine_state()

    def _note_state(self, old: str, new: str, via: str):
        """Journal one cluster state transition (the phase changes an
        operator reconstructs an incident from: STARTING/NORMAL/
        DEGRADED/RESIZING)."""
        if old == new:
            return
        self.journal.append(
            "cluster.state", node=self.node.id, via=via,
            **{"from": old, "to": new},
        )

    def _determine_state(self):
        """determineClusterState (cluster.go:522)."""
        with self._lock:
            if self.state == STATE_RESIZING:
                return
            old = self.state
            down = sum(1 for n in self.nodes if n.state == "DOWN")
            if down == 0:
                self.state = STATE_NORMAL
            elif down < self.replica_n:
                self.state = STATE_DEGRADED
            else:
                self.state = STATE_STARTING
            new = self.state
        self._note_state(old, new, via="membership")

    def set_state(self, state: str):
        with self._lock:
            old = self.state
            self.state = state
        self._note_state(old, state, via="set-state")

    def _emit(self, kind: str, node: Node):
        for fn in self.event_listeners:
            fn(kind, node)

    def set_coordinator(self, node_id: str):
        with self._lock:
            old = self.coordinator()
            new = self.node_by_id(node_id)
            if new is None:
                raise ValueError(f"node not found: {node_id}")
            for n in self.nodes:
                n.is_coordinator = n.id == node_id
            self.node.is_coordinator = self.node.id == node_id
            self.save_topology()
        return (
            old.to_dict() if old else None,
            new.to_dict(),
        )

    def abort_resize(self):
        """Abort the RUNNING resize job (api.go ResizeAbort :1114 ->
        completeCurrentJob(ABORTED)).  The coordinator thread blocked in
        _run_resize observes the terminal state and restores NORMAL;
        a no-op when no job is running (ErrResizeNotRunning is a 400 in
        the reference; here the legacy state flip is kept for
        coordinator-less deployments)."""
        job = self.current_job
        if job is not None:
            job.abort("resize aborted")
            return
        with self._lock:
            if self.state == STATE_RESIZING:
                self.state = STATE_NORMAL

    def receive_message(self, msg: dict):
        typ = msg.get("type")
        if typ == "node-join":
            self.add_node(Node.from_dict(msg["node"]), resize=msg.get("resize", True))
        elif typ == "node-leave":
            self.remove_node(msg["node"]["id"], resize=msg.get("resize", True))
        elif typ == "set-state":
            self.set_state(msg["state"])
        elif typ == "resize-instruction":
            self.follow_resize_instruction(msg)
        elif typ == "resize-complete":
            self.mark_resize_complete(msg)

    # -- broadcast (broadcast.go SendSync, server.go:582-604) --------------

    def send_sync(self, msg: dict):
        """POST the message to every other node."""
        for n in list(self.nodes):
            if n.id == self.node.id:
                continue
            try:
                self.client(n).send_message(msg)
            except Exception as e:
                if self.logger:
                    self.logger.printf("broadcast to %s failed: %s", n.id, e)

    def send_to(self, node: Node, msg: dict):
        self.client(node).send_message(msg)

    def send_async(self, msg: dict):
        """Gossip-piggybacked broadcast (broadcast.go SendAsync): rides
        the SWIM traffic when a gossip transport is attached, falling
        back to the synchronous HTTP fan-out otherwise."""
        if self.gossip_send_async is not None:
            self.gossip_send_async(msg)
        else:
            self.send_sync(msg)

    # -- resize (cluster.go :741-826, 1150-1497) ---------------------------

    def frag_sources(
        self, old_nodes: List[Node], new_nodes: List[Node]
    ) -> Dict[str, List[ResizeSource]]:
        """Per-node list of fragments to fetch after placement changed
        (cluster.go fragSources :741-826)."""
        if self.holder is None:
            return {}

        def placement(nodes: List[Node], index: str, shard: int) -> List[Node]:
            # Same capacity-weighted math as live routing (place_partition
            # is the single source of placement truth) — a resize diff
            # computed with different math would strand or double-copy
            # fragments.
            return place_partition(
                nodes, self.replica_n, self.partition(index, shard)
            )

        out: Dict[str, List[ResizeSource]] = {n.id: [] for n in new_nodes}
        for index_name, idx in self.holder.indexes.items():
            for shard in idx.available_shards():
                shard = int(shard)
                old_owners = placement(old_nodes, index_name, shard)
                new_owners = placement(new_nodes, index_name, shard)
                old_ids = {n.id for n in old_owners}
                for target in new_owners:
                    if target.id in old_ids:
                        continue
                    source = next(
                        (n for n in old_owners if any(
                            m.id == n.id for m in new_nodes
                        )),
                        old_owners[0] if old_owners else None,
                    )
                    if source is None:
                        continue
                    for f in idx.fields.values():
                        for view_name in f.views:
                            out[target.id].append(
                                ResizeSource(
                                    source, index_name, f.name, view_name, shard
                                )
                            )
        return out

    # Instruction delivery retries before the job aborts (the reference
    # aborts on the first SendTo failure, cluster.go:1448-1456;
    # re-delivery shields one transient connection blip without
    # changing the clean-failure semantics).
    RESIZE_SEND_RETRIES = 3
    RESIZE_SEND_BACKOFF = 0.2
    # Ceiling on a whole job: a node that accepted its instruction but
    # never reports (crashed mid-fetch) must not pin RESIZING forever.
    RESIZE_JOB_TIMEOUT = 300.0
    # Terminal jobs retained in ``jobs`` for inspection.
    MAX_JOB_HISTORY = 16

    def _run_resize(
        self,
        old_nodes: List[Node],
        new_nodes: List[Node],
        apply_membership: Optional[Callable[[], None]] = None,
        action: Optional[tuple] = None,
    ) -> str:
        """Coordinator-driven resize as a tracked JOB
        (generateResizeJob :1150-1230 + handleNodeAction :1017-1068):
        compute per-node sources, record a ResizeJob, deliver the
        instructions (with bounded re-delivery), then stay RESIZING
        until every node reports ``resize-complete`` or the job aborts —
        a lost instruction aborts the job loudly instead of silently
        flipping back to NORMAL.  ``new_nodes``
        is the PROSPECTIVE membership; on RESIZE_JOB_DONE the caller's
        ``apply_membership`` closure runs WHILE the cluster is still
        RESIZING — membership + topology save + node-status broadcast
        must land before any peer can see NORMAL, or a peer routing on
        the old membership could write to a fragment already moved to
        its new owner (a lost-write window).  Only the abort path keeps
        the immediate NORMAL restore.  ``action`` (("join", node) /
        ("leave", node_id)) is queued for replay instead of being
        silently dropped when another job is already running.  Returns
        the job's final state."""
        with self._lock:
            if self.current_job is not None:
                # One job at a time (cluster.go:1163-1166).  A carried
                # action is queued and replayed when the running job
                # finishes, so the joiner/leaver eventually lands.
                if action is not None:
                    self._pending_node_actions.append(action)
                    if self.logger:
                        self.logger.printf(
                            "resize job %d running; queued node %s",
                            self.current_job.id,
                            action[0],
                        )
                    self.journal.append(
                        "cluster.resize.queued",
                        behindJob=self.current_job.id, action=action[0],
                    )
                    return RESIZE_JOB_QUEUED
                if self.logger:
                    self.logger.printf(
                        "resize job %d already running; rejecting new job",
                        self.current_job.id,
                    )
                return RESIZE_JOB_ABORTED
            job = ResizeJob([n.id for n in new_nodes], action="diff")
            self.jobs[job.id] = job
            self.current_job = job
        self.journal.append(
            "cluster.resize.start", jobId=job.id,
            action=action[0] if action else "diff",
            nodes=[n.id for n in new_nodes],
        )
        self.set_state(STATE_RESIZING)
        self.send_sync({"type": "set-state", "state": STATE_RESIZING})
        try:
            sources = self.frag_sources(old_nodes, new_nodes)
            for node in new_nodes:
                node_sources = sources.get(node.id, [])
                if not node_sources:
                    # No fetches for this node: complete immediately
                    # (cluster.go:1211-1214).
                    job.mark_node_complete(node.id)
                    continue
                instruction = {
                    "type": "resize-instruction",
                    "jobId": job.id,
                    "node": node.to_dict(),
                    "coordinator": self.node.to_dict(),
                    "sources": [
                        {
                            "uri": s.node.uri,
                            "index": s.index,
                            "field": s.field,
                            "view": s.view,
                            "shard": s.shard,
                        }
                        for s in node_sources
                    ],
                }
                job.instructions.append(instruction)
                if not self._deliver_instruction(node, instruction):
                    job.abort(f"instruction delivery to {node.id} failed")
                    break
            state = job.wait(self.RESIZE_JOB_TIMEOUT)
            if state != RESIZE_JOB_DONE and self.logger:
                self.logger.printf(
                    "resize job %d aborted: %s", job.id, job.error
                )
            self.journal.append(
                "cluster.resize.done" if state == RESIZE_JOB_DONE
                else "cluster.resize.abort",
                jobId=job.id, state=state, error=job.error or "",
            )
            if state == RESIZE_JOB_DONE and apply_membership is not None:
                apply_membership()
            return state
        finally:
            with self._lock:
                self.current_job = None
                # Keep a short job history for admin/debug visibility;
                # unbounded retention would leak instruction lists on a
                # long-lived coordinator with membership churn.
                while len(self.jobs) > self.MAX_JOB_HISTORY:
                    self.jobs.pop(next(iter(self.jobs)))
            self.set_state(STATE_NORMAL)
            self.send_sync({"type": "set-state", "state": STATE_NORMAL})
            self._kick_pending_node_actions()

    def _kick_pending_node_actions(self):
        """Replay join/leave actions that arrived during the finished
        job.  Runs on a fresh thread: a queued action starts a whole new
        resize job, and the caller may be a gossip/message handler that
        must not block for its duration."""
        with self._lock:
            if not self._pending_node_actions:
                return
            actions = self._pending_node_actions
            self._pending_node_actions = []

        def run():
            for kind, arg in actions:
                try:
                    if kind == "join":
                        self.add_node(arg)
                    elif kind == "reweigh":
                        node = self.node_by_id(arg[0])
                        if node is not None:
                            self._reweigh_node(node, arg[1])
                    else:
                        self.remove_node(arg)
                except Exception as e:  # noqa: BLE001
                    if self.logger:
                        self.logger.printf(
                            "queued node %s replay failed: %s", kind, e
                        )

        threading.Thread(
            target=run, daemon=True, name="pending-node-actions"
        ).start()

    def _deliver_instruction(self, node: Node, instruction: dict) -> bool:
        """Deliver one resize instruction with bounded re-delivery.
        Local instructions execute directly (the reference's local node
        also receives its own broadcast)."""
        if node.id == self.node.id:
            self.follow_resize_instruction(instruction)
            return True
        for attempt in range(self.RESIZE_SEND_RETRIES):
            try:
                self.send_to(node, instruction)
                return True
            except Exception as e:
                if self.logger:
                    self.logger.printf(
                        "resize instruction to %s failed (attempt %d): %s",
                        node.id, attempt + 1, e,
                    )
                if attempt + 1 < self.RESIZE_SEND_RETRIES:
                    time.sleep(self.RESIZE_SEND_BACKOFF * (attempt + 1))
        return False

    def mark_resize_complete(self, msg: dict):
        """A node finished (or failed) its instruction
        (markResizeInstructionComplete, cluster.go:1349-1372)."""
        job = self.jobs.get(msg.get("jobId"))
        if job is None:
            if self.logger:
                self.logger.printf(
                    "resize completion for unknown job %s", msg.get("jobId")
                )
            return
        job.mark_node_complete(msg["node"]["id"], msg.get("error", ""))

    def node_status(self) -> dict:
        """Schema + per-field available shards (server.go NodeStatus
        :626-674) — exchanged on join and periodically so every node can
        route queries to shards it doesn't hold."""
        status = {
            "type": "node-status",
            "node": self.node.to_dict(),
            "state": self.state,
            "indexes": {},
            "tombstones": [],
            "versions": {},
            # Completed error-free anti-entropy passes on this node:
            # peers release their bounded-read quarantine of us when
            # this advances past their post-recovery baseline.
            "aePasses": self.ae_passes,
            # Pending-hint advertisement (docs/durability.md "Hinted
            # handoff"): {target node id: un-replayed records} — peers
            # hold the target's quarantine while any advertiser is
            # nonzero, and the target itself DEFERS its anti-entropy
            # passes (syncer) until every advertisement for it clears.
            "pendingHints": (
                self.hints.pending_map() if self.hints is not None else {}
            ),
        }
        if self.holder is None:
            return status
        # Per-index data-version tokens: the heartbeat payload bounded
        # replica reads consult (receivers record via note_heartbeat).
        try:
            status["versions"] = self.holder.data_versions()
        except Exception:  # noqa: BLE001 — status must always render
            pass
        # Deleted-schema tombstones travel with the status so a peer that
        # missed a delete broadcast applies it here instead of this
        # exchange resurrecting the object from the peer's stale schema.
        status["tombstones"] = sorted(self.holder.schema_tombstones)
        for name, idx in self.holder.indexes.items():
            fields = {}
            for fname, f in idx.fields.items():
                fields[fname] = {
                    "options": f.options.to_dict(),
                    "cid": f.creation_id,
                    "views": sorted(f.views.keys()),
                    "availableShards": [int(s) for s in f.available_shards()],
                }
            status["indexes"][name] = {
                "keys": idx.keys,
                "cid": idx.creation_id,
                "fields": fields,
            }
        return status

    def follow_resize_instruction(self, instruction: dict):
        """Fetch each missing fragment from its source over the data
        plane, ASYNCHRONOUSLY, then report completion (or the first
        error) to the coordinator (followResizeInstruction :1251-1347:
        the work runs in a goroutine so instruction distribution to the
        rest of the cluster is never blocked)."""
        job_id = instruction.get("jobId")
        coordinator = instruction.get("coordinator")

        def run():
            error = ""
            try:
                self._fetch_resize_sources(instruction.get("sources", []))
            except Exception as e:  # first error stops processing
                error = str(e)
            if job_id is None:
                return  # legacy instruction: no completion protocol
            complete = {
                "type": "resize-complete",
                "jobId": job_id,
                "node": instruction.get("node", self.node.to_dict()),
                "error": error,
            }
            try:
                if coordinator and coordinator["id"] != self.node.id:
                    self.send_to(Node.from_dict(coordinator), complete)
                else:
                    self.mark_resize_complete(complete)
            except Exception as e:
                if self.logger:
                    self.logger.printf(
                        "sending resize completion failed: %s", e
                    )

        t = threading.Thread(target=run, daemon=True, name="resize-follow")
        t.start()
        return t

    def _fetch_resize_sources(self, sources: List[dict]):
        """The fetch loop: any failure raises (aborting the job), except
        a missing remote fragment — an empty shard whose placement moved
        is expected and skipped (cluster.go:1310-1319)."""
        for src in sources:
            client = self._clients.get(src["uri"])
            if client is None:
                client = self._client_factory(src["uri"])
                self._clients[src["uri"]] = client
            try:
                data = client.retrieve_shard(
                    src["index"], src["field"], src["shard"], view=src["view"]
                )
            except Exception as e:
                code = getattr(e, "code", None)
                if code == 404:
                    continue  # fragment has no data on the source
                raise
            if self.holder is None:
                continue
            idx = self.holder.index(src["index"])
            if idx is None:
                continue
            f = idx.field(src["field"])
            if f is None:
                continue
            frag = f.view_if_not_exists(src["view"]).fragment_if_not_exists(
                src["shard"]
            )
            frag.import_roaring(data)

    # -- holder cleaner (holder.go holderCleaner :852-902) -----------------

    def clean_holder(self):
        """Remove fragments this node no longer owns."""
        if self.holder is None:
            return
        for index_name, idx in self.holder.indexes.items():
            removed = False
            for f in idx.fields.values():
                for view in f.views.values():
                    for shard in list(view.fragments):
                        if not self.owns_shard(self.node.id, index_name, shard):
                            frag = view.fragments.pop(shard)
                            frag.close()
                            removed = True
            if removed:
                self.holder.bump_shard_epoch(index_name)

    # -- topology persistence (cluster.go :1593-1628) ----------------------

    def _topology_path(self) -> Optional[str]:
        if self.path is None:
            return None
        return os.path.join(self.path, ".topology")

    def save_topology(self):
        """Atomic: temp + fsync + os.replace — a SIGKILL mid-save must
        leave the previous intact topology, never a torn JSON a restart
        refuses to parse (this used to write ``.topology`` in place)."""
        p = self._topology_path()
        if p is None:
            return
        os.makedirs(self.path, exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"nodes": [n.to_dict() for n in self.nodes]}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def load_topology(self):
        """Tolerant load: a corrupt topology (crash predating the atomic
        writer, disk damage) logs and boots single-node — membership
        re-forms via gossip/NodeStatus — instead of failing the boot."""
        p = self._topology_path()
        if p is None or not os.path.exists(p):
            return
        try:
            with open(p) as f:
                doc = json.load(f)
            nodes = [Node.from_dict(d) for d in doc.get("nodes", [])]
        except (json.JSONDecodeError, OSError, KeyError, TypeError,
                ValueError) as e:
            if self.logger:
                self.logger.printf(
                    "corrupt topology %s (%s): booting single-node; "
                    "membership will re-form via gossip", p, e,
                )
            return
        with self._lock:
            by_id = {n.id: n for n in nodes}
            by_id[self.node.id] = self.node
            self.nodes = sorted(by_id.values(), key=lambda n: n.id)
