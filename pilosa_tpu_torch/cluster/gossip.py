"""SWIM gossip membership: UDP probing + TCP push/pull + piggybacked
dissemination.

The stand-in for the reference's memberlist transport (gossip/gossip.go
:170-541), with the same three channels memberlist uses:

- **UDP datagrams** (JSON) for the failure-detector probes and routine
  gossip: ``ping`` / ``ack`` / ``ping-req`` — each piggybacking recent
  membership updates and user broadcasts (the broadcast queue).
- **TCP push/pull full-state sync** (4-byte length + JSON stream) on
  join and on a periodic timer (memberlist LocalState/MergeRemoteState,
  gossip/gossip.go:248-315): both sides exchange their complete member
  list + pending broadcasts, so state larger than one datagram — or
  missed by dropped packets — still converges.
- **TCP fallback for oversized sends**: any message whose encoding
  exceeds the UDP MTU budget is streamed over TCP instead of being
  silently truncated (memberlist's reliable channel; the shared
  TCP/UDP transport of gossip/gossip.go:398-476).

User broadcasts (``send_async``, broadcast.go SendAsync) ride the same
piggyback queue with a retransmit budget (scaled with cluster size, as
memberlist's RetransmitMult) and id-dedup.  Delivery to ``on_message``
is AT-LEAST-ONCE: dedup ids expire (bounded memory) while a peer may
still retransmit or push/pull the broadcast, so a late redelivery can
fire the handler again — cluster message handlers must be idempotent
(api.cluster_message documents how each one is).

State machine per member: ALIVE -> SUSPECT (probe failed) -> DEAD
(suspicion timeout = suspicion_mult * probe_interval), with refutation:
a node seeing itself suspected re-broadcasts alive with a bumped
incarnation.  Events (join/leave) feed cluster.add_node /
cluster.node_failed the way memberlist events feed
cluster.ReceiveEvent (cluster.go:1658).

A copy of ``pilosa_tpu/cluster/gossip.py``.
"""

from __future__ import annotations

import base64
import json
import math
import random
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional

from ..util import events as events_mod
from ..util.stats import METRIC_GOSSIP_TRANSITIONS, REGISTRY

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"

_MAX_PIGGYBACK = 8
_MAX_BCAST_PIGGYBACK = 4


class Member:
    __slots__ = ("id", "addr", "meta", "state", "incarnation", "since")

    def __init__(self, id, addr, meta=None, state=ALIVE, incarnation=0):
        self.id = id
        self.addr = tuple(addr)
        self.meta = meta or {}
        self.state = state
        self.incarnation = incarnation
        self.since = time.monotonic()

    def to_update(self) -> dict:
        return {
            "id": self.id,
            "addr": list(self.addr),
            "meta": self.meta,
            "state": self.state,
            "inc": self.incarnation,
        }


class GossipNode:
    def __init__(
        self,
        node_id: str,
        meta: Optional[dict] = None,
        bind: str = "127.0.0.1",
        port: int = 0,
        probe_interval: float = 0.3,
        probe_timeout: float = 0.2,
        suspicion_mult: int = 4,
        indirect_checks: int = 2,
        push_pull_interval: float = 2.0,
        mtu: int = 1400,
        broadcast_retransmits: int = 4,
        on_join: Optional[Callable] = None,
        on_leave: Optional[Callable] = None,
        on_message: Optional[Callable] = None,
        on_alive: Optional[Callable] = None,
        logger=None,
        journal=None,
        dead_reap_seconds: float = 30.0,
    ):
        self.node_id = node_id
        self.meta = meta or {}
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.suspicion_timeout = suspicion_mult * probe_interval
        self.indirect_checks = indirect_checks
        self.push_pull_interval = push_pull_interval
        self.mtu = mtu
        self.broadcast_retransmits = broadcast_retransmits
        self.on_join = on_join
        self.on_leave = on_leave
        self.on_message = on_message
        # Direct-liveness hook: fired with a member id on every direct
        # contact (datagram/stream received from it, or a successful
        # probe ack).  The server wires this to cluster.note_heartbeat —
        # the freshness evidence bounded replica reads run on.  Relayed
        # third-party updates do NOT fire it: they prove the relayer is
        # alive, not the subject.
        self.on_alive = on_alive
        self.logger = logger
        # Structured event journal: every membership state transition,
        # join, and DEAD-member reap lands here (and in the
        # pilosa_gossip_state_transitions_total{from,to} counter) — a
        # flapping member is visible at /debug/events?type=gossip
        # instead of only as silent member-table mutation.
        self.journal = journal if journal is not None else events_mod.JOURNAL
        # DEAD members are kept this long (so late updates about them
        # still rank against their incarnation), then reaped from the
        # member table — journaled, not silently dropped.
        self.dead_reap_seconds = dead_reap_seconds

        # Shared-port UDP+TCP transport (memberlist's shared transport).
        # With port=0 the kernel picks the UDP port; the matching TCP port
        # may be taken by an unrelated socket, so retry on a fresh
        # ephemeral pair rather than failing.
        for attempt in range(32):
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.bind((bind, port))
            self._sock.settimeout(0.1)
            self.addr = self._sock.getsockname()
            self._tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                self._tcp.bind(self.addr)
            except OSError:
                self._sock.close()
                self._tcp.close()
                if port != 0 or attempt == 31:
                    raise
                continue
            break
        self._tcp.listen(16)
        self._tcp.settimeout(0.1)

        self._lock = threading.RLock()
        self.members: Dict[str, Member] = {
            node_id: Member(node_id, self.addr, self.meta)
        }
        self.incarnation = 0
        self._acks: Dict[str, threading.Event] = {}
        self._updates: List[dict] = []  # piggyback broadcast queue
        # User broadcasts: id -> [payload, remaining_retransmits]
        self._bcasts: Dict[str, list] = {}
        self._seen_bcasts: Dict[str, float] = {}
        self._bcast_seq = 0
        self._closing = threading.Event()
        self._threads = []
        # Fault-injection hook (the clustertests' pumba stand-in): drop
        # this fraction of outgoing UDP datagrams.  TCP is unaffected.
        self.udp_drop_prob = 0.0

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        for fn in (
            self._listen_loop,
            self._tcp_listen_loop,
            self._probe_loop,
            self._reap_loop,
            self._push_pull_loop,
        ):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def join(self, seed_addr):
        """Push/pull full state with a seed over TCP (memberlist Join);
        falls back to a UDP join datagram if the stream fails."""
        if not self._push_pull(tuple(seed_addr)):
            self._send(tuple(seed_addr), {"type": "join"})

    def close(self):
        self._closing.set()
        for s in (self._sock, self._tcp):
            try:
                s.close()
            except OSError:
                pass

    # -- user broadcasts (SendAsync) ---------------------------------------

    def send_async(self, payload: dict):
        """Queue an arbitrary message to gossip to every member
        (broadcast.go SendAsync): piggybacks on probe traffic with a
        retransmit budget, id-deduped at receivers, also exchanged in
        push/pull syncs.

        Cluster messages travel as [1-byte type][protobuf] frames
        (net.privproto), base64-wrapped inside the gossip envelope —
        the payload encoding parity of broadcast.go:75-83; payloads the
        frame codec doesn't know stay plain JSON."""
        try:
            from ..net import privproto

            payload = {
                "pb": base64.b64encode(
                    privproto.marshal_cluster_message(payload)
                ).decode()
            }
        except (ValueError, KeyError, TypeError):
            pass  # non-cluster payload: gossip it as-is
        with self._lock:
            self._bcast_seq += 1
            bid = f"{self.node_id}-{self._bcast_seq}"
            self._bcasts[bid] = [payload, self._retransmit_budget()]
            self._seen_bcasts[bid] = time.monotonic()

    def _retransmit_budget(self) -> int:
        """Retransmit budget scaled to cluster size (memberlist's
        RetransmitMult * ceil(log10(n+1))): a fixed budget starves large
        clusters because sends target random — possibly repeated —
        peers.  Caller holds the lock."""
        n = len(self.members)
        return max(
            self.broadcast_retransmits,
            self.broadcast_retransmits * math.ceil(math.log10(n + 1)),
        )

    def _take_bcasts(self) -> List[dict]:
        out = []
        with self._lock:
            done = []
            for bid, entry in list(self._bcasts.items())[:_MAX_BCAST_PIGGYBACK]:
                payload, left = entry
                out.append({"id": bid, "payload": payload})
                entry[1] = left - 1
                if entry[1] <= 0:
                    done.append(bid)
            for bid in done:
                del self._bcasts[bid]
        return out

    def _handle_bcasts(self, bcasts: List[dict]):
        for b in bcasts or []:
            bid = b.get("id")
            if not bid:
                continue
            with self._lock:
                if bid in self._seen_bcasts:
                    continue
                self._seen_bcasts[bid] = time.monotonic()
                # Re-gossip what we just learned (memberlist broadcast
                # queue semantics).
                self._bcasts[bid] = [b.get("payload"), self._retransmit_budget()]
            if self.on_message is not None:
                try:
                    self.on_message(self._decode_payload(b.get("payload")))
                except Exception:
                    pass

    @staticmethod
    def _decode_payload(payload):
        """Unwrap a [type][protobuf] frame back to the handler dict;
        plain payloads pass through."""
        if isinstance(payload, dict) and set(payload) == {"pb"}:
            from ..net import privproto

            return privproto.unmarshal_cluster_message(
                base64.b64decode(payload["pb"])
            )
        return payload

    # -- wire --------------------------------------------------------------

    def _encode(self, msg: dict) -> bytes:
        msg["from"] = self.node_id
        with self._lock:
            msg["updates"] = self._updates[-_MAX_PIGGYBACK:] + [
                self.members[self.node_id].to_update()
            ]
        bcasts = self._take_bcasts()
        if bcasts:
            msg["bcasts"] = bcasts
        return json.dumps(msg).encode()

    def _send(self, addr, msg: dict):
        if self._fault_dropped(addr):
            return
        data = self._encode(msg)
        if len(data) > self.mtu:
            # Oversized for a datagram: stream it (memberlist's TCP
            # fallback) instead of truncating or dropping.
            self._send_tcp(tuple(addr), data)
            return
        if self.udp_drop_prob and random.random() < self.udp_drop_prob:
            return  # injected packet loss
        try:
            self._sock.sendto(data, tuple(addr))
        except OSError:
            pass

    def _send_tcp(self, addr, data: bytes):
        try:
            with socket.create_connection(addr, timeout=self.probe_timeout * 4) as c:
                c.sendall(struct.pack("<I", len(data)) + data)
        except OSError:
            pass

    def _queue_update(self, update: dict):
        with self._lock:
            self._updates.append(update)
            if len(self._updates) > 64:
                self._updates = self._updates[-64:]

    # -- TCP push/pull (memberlist LocalState/MergeRemoteState) ------------

    def _local_state(self) -> dict:
        with self._lock:
            return {
                "type": "push-pull",
                "from": self.node_id,
                "members": [m.to_update() for m in self.members.values()],
                "bcasts": [
                    {"id": bid, "payload": e[0]}
                    for bid, e in list(self._bcasts.items())
                ],
            }

    def _merge_state(self, state: dict):
        for update in state.get("members", []):
            self._apply_update(update)
        self._handle_bcasts(state.get("bcasts"))

    @staticmethod
    def _fault_dropped(addr) -> bool:
        """Deterministic fault plane (net/faults.py): gossip honors
        drop/partition rules on OUTGOING traffic, so a scripted
        partition silences this node's probes/acks/push-pulls toward
        the other side exactly like a real network cut — the failure
        detector then reaches its SUSPECT/DEAD verdicts organically."""
        from ..net.faults import PLANE

        if not PLANE.active:
            return False
        rule = PLANE.intercept(
            f"{addr[0]}:{addr[1]}", "gossip", transport="gossip"
        )
        return rule is not None and rule.action in ("drop", "partition")

    def _push_pull(self, addr) -> bool:
        """Full bidirectional state exchange over one TCP stream."""
        if self._fault_dropped(addr):
            return False
        try:
            with socket.create_connection(
                addr, timeout=self.probe_timeout * 8
            ) as c:
                data = json.dumps(self._local_state()).encode()
                c.sendall(struct.pack("<I", len(data)) + data)
                remote = _read_frame(c)
        except (OSError, ValueError):
            return False
        if remote is None:
            return False
        self._merge_state(remote)
        self._note_alive(remote.get("from"))
        return True

    def _push_pull_loop(self):
        while not self._closing.wait(self.push_pull_interval):
            with self._lock:
                peers = [
                    m
                    for m in self.members.values()
                    if m.id != self.node_id and m.state == ALIVE
                ]
            if peers:
                self._push_pull(random.choice(peers).addr)

    def _tcp_listen_loop(self):
        while not self._closing.is_set():
            try:
                conn, _ = self._tcp.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._tcp_handle, args=(conn,), daemon=True
            ).start()

    def _tcp_handle(self, conn):
        with conn:
            conn.settimeout(self.probe_timeout * 8)
            try:
                msg = _read_frame(conn)
            except (OSError, ValueError):
                return
            if msg is None:
                return
            if msg.get("type") == "push-pull":
                # Respond with our state, then merge theirs.
                try:
                    data = json.dumps(self._local_state()).encode()
                    conn.sendall(struct.pack("<I", len(data)) + data)
                except OSError:
                    pass
                self._merge_state(msg)
                self._note_alive(msg.get("from"))
            else:
                # An oversized regular message delivered via stream.
                self._handle(msg, None)

    # -- UDP loops ---------------------------------------------------------

    def _listen_loop(self):
        while not self._closing.is_set():
            try:
                data, addr = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                msg = json.loads(data)
            except json.JSONDecodeError:
                continue
            self._handle(msg, addr)

    def _sender_addr(self, msg: dict, addr):
        """Reply address: the socket source, else the member table (TCP
        deliveries have no datagram source)."""
        if addr is not None:
            return addr
        with self._lock:
            m = self.members.get(msg.get("from", ""))
        return m.addr if m is not None else None

    def _note_alive(self, member_id):
        if member_id and member_id != self.node_id and self.on_alive:
            try:
                self.on_alive(member_id)
            except Exception:  # noqa: BLE001 — liveness hook must not wedge IO
                pass

    def _handle(self, msg: dict, addr):
        for update in msg.get("updates", []):
            self._apply_update(update)
        self._handle_bcasts(msg.get("bcasts"))
        # Any message FROM a member is direct evidence it is alive now.
        self._note_alive(msg.get("from"))
        typ = msg.get("type")
        reply_to = self._sender_addr(msg, addr)
        if typ == "ping":
            if reply_to is not None:
                self._send(reply_to, {"type": "ack", "seq": msg.get("seq")})
        elif typ == "ack":
            ev = self._acks.get(msg.get("seq"))
            if ev is not None:
                ev.set()
        elif typ == "ping-req":
            # Probe the target on behalf of the requester.
            target = msg.get("target")
            with self._lock:
                m = self.members.get(target)
            if m is not None and self._probe_once(m) and reply_to is not None:
                self._send(reply_to, {"type": "ack", "seq": msg.get("seq")})
        elif typ == "join":
            if reply_to is not None:
                with self._lock:
                    full = [m.to_update() for m in self.members.values()]
                self._send(reply_to, {"type": "state", "members": full})
        elif typ == "state":
            for update in msg.get("members", []):
                self._apply_update(update)

    def _apply_update(self, u: dict):
        uid = u["id"]
        if uid == self.node_id:
            # Refute suspicion about ourselves (memberlist aliveness).
            if u["state"] in (SUSPECT, DEAD) and u["inc"] >= self.incarnation:
                self.incarnation = u["inc"] + 1
                with self._lock:
                    me = self.members[self.node_id]
                    me.incarnation = self.incarnation
                    me.state = ALIVE
                self._queue_update(me.to_update())
                self.journal.append(
                    "gossip.refute", member=uid,
                    suspected_as=u["state"], incarnation=self.incarnation,
                )
            return
        joined = False
        left = False
        prev = None
        new_state = None
        with self._lock:
            m = self.members.get(uid)
            if m is None:
                if u["state"] == DEAD:
                    return
                m = Member(uid, u["addr"], u.get("meta"), u["state"], u["inc"])
                self.members[uid] = m
                joined = True
            else:
                # Higher incarnation wins; equal incarnation: worse state
                # wins (suspect over alive).
                rank = {ALIVE: 0, SUSPECT: 1, DEAD: 2}
                if u["inc"] < m.incarnation:
                    return
                if u["inc"] == m.incarnation and rank[u["state"]] <= rank[m.state]:
                    return
                was_dead = m.state == DEAD
                if m.state != u["state"]:
                    prev = m.state
                    new_state = u["state"]
                m.state = u["state"]
                m.incarnation = u["inc"]
                m.since = time.monotonic()
                if m.state == DEAD and not was_dead:
                    left = True
                if was_dead and m.state == ALIVE:
                    joined = True
            self._queue_update(m.to_update())
        if prev is not None:
            # A transition learned from a peer's update (not our own
            # probe) still journals + counts: both survivors of a
            # failure see the SUSPECT -> DEAD sequence in THEIR journal.
            self._record_transition(uid, prev, new_state, via="update")
        elif joined:
            self.journal.append("gossip.join", member=uid, state=m.state)
        if joined and self.on_join:
            self.on_join(m)
        if left and self.on_leave:
            self.on_leave(m)

    def _probe_loop(self):
        while not self._closing.wait(self.probe_interval):
            with self._lock:
                candidates = [
                    m
                    for m in self.members.values()
                    if m.id != self.node_id and m.state != DEAD
                ]
            if not candidates:
                continue
            target = random.choice(candidates)
            if self._probe_once(target):
                self._mark(target.id, ALIVE)
                self._note_alive(target.id)
                continue
            # Indirect probes through k proxies (SWIM ping-req).
            proxies = [m for m in candidates if m.id != target.id]
            random.shuffle(proxies)
            seq = f"{self.node_id}-{time.monotonic()}"
            ev = threading.Event()
            self._acks[seq] = ev
            for proxy in proxies[: self.indirect_checks]:
                self._send(
                    proxy.addr,
                    {"type": "ping-req", "target": target.id, "seq": seq},
                )
            ok = ev.wait(self.probe_timeout * 2)
            self._acks.pop(seq, None)
            if ok:
                self._mark(target.id, ALIVE)
            else:
                self._mark(target.id, SUSPECT)

    def _probe_once(self, m: Member) -> bool:
        seq = f"{self.node_id}-{time.monotonic()}-{random.random()}"
        ev = threading.Event()
        self._acks[seq] = ev
        self._send(m.addr, {"type": "ping", "seq": seq})
        ok = ev.wait(self.probe_timeout)
        self._acks.pop(seq, None)
        return ok

    def _record_transition(self, uid: str, frm: str, to: str, via: str):
        """One member state transition: a journal event plus the
        pilosa_gossip_state_transitions_total{from,to} counter.  ``via``
        says which mechanism observed it (probe, update, reap) —
        distinguishing a local failure-detector verdict from a
        gossip-learned one."""
        self.journal.append(
            "gossip.transition", member=uid,
            **{"from": frm, "to": to, "via": via},
        )
        REGISTRY.inc(METRIC_GOSSIP_TRANSITIONS, **{"from": frm, "to": to})

    def _mark(self, uid: str, state: str):
        left = False
        with self._lock:
            m = self.members.get(uid)
            if m is None or m.state == state:
                return
            if m.state == DEAD and state != ALIVE:
                return
            was_dead = m.state == DEAD
            prev = m.state
            m.state = state
            m.since = time.monotonic()
            if state == DEAD and not was_dead:
                left = True
            self._queue_update(m.to_update())
        self._record_transition(uid, prev, state, via="probe")
        if left and self.on_leave:
            self.on_leave(m)

    def _reap_loop(self):
        """Promote timed-out suspects to dead (suspicion timeout),
        remove long-DEAD members from the table (journaled — removal is
        a membership fact an operator reconstructing a flap needs, not
        silent bookkeeping), and expire old broadcast-dedup ids
        (bounded memory)."""
        while not self._closing.wait(self.probe_interval):
            now = time.monotonic()
            with self._lock:
                horizon = now - max(300.0, self.push_pull_interval * 20)
                for bid in [
                    b for b, t in self._seen_bcasts.items()
                    if t < horizon and b not in self._bcasts
                ]:
                    del self._seen_bcasts[bid]
            dead = []
            reaped = []
            with self._lock:
                for m in list(self.members.values()):
                    if (
                        m.state == SUSPECT
                        and now - m.since > self.suspicion_timeout
                    ):
                        dead.append(m.id)
                    elif (
                        m.state == DEAD
                        and m.id != self.node_id
                        and now - m.since > self.dead_reap_seconds
                    ):
                        del self.members[m.id]
                        reaped.append(m.id)
            for uid in reaped:
                self.journal.append(
                    "gossip.reap", member=uid,
                    after_seconds=round(self.dead_reap_seconds, 3),
                )
            for uid in dead:
                self._mark(uid, DEAD)

    # -- introspection -----------------------------------------------------

    def alive_members(self) -> List[Member]:
        with self._lock:
            return [m for m in self.members.values() if m.state == ALIVE]

    def member_states(self) -> Dict[str, str]:
        """{member id: state} snapshot — the readiness probe's
        convergence check reads this without touching the lock-guarded
        table directly."""
        with self._lock:
            return {m.id: m.state for m in self.members.values()}


def _read_frame(conn) -> Optional[dict]:
    """Read one [u32 length][json] frame from a stream socket."""
    head = _read_exact(conn, 4)
    if head is None:
        return None
    (n,) = struct.unpack("<I", head)
    if n > 64 << 20:
        raise ValueError(f"gossip frame too large: {n}")
    body = _read_exact(conn, n)
    if body is None:
        return None
    return json.loads(body)


def _read_exact(conn, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf
