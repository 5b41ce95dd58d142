"""Deterministic network-fault plane (docs/durability.md "Fault plane").

A copy of ``pilosa_tpu/net/faults.py`` (stdlib only).  On a single node
the served side is the boundary that matters: ``Handler.handle`` and the
reactor's inline query path consult ``intercept(..., transport="serve")``
so that an injected ``error`` reaches ``pilosa_server_errors_total`` and
the SLO watcher's error rate; ``InternalClient._do`` consults it before
each outbound request.  The gossip transport comes with ROADMAP.md Queue 1
item 15.

The clustertests-with-fault-injection gap (SURVEY.md §445): until now the
only failure the chaos lanes could inject was a whole-process
SIGKILL/SIGSTOP — partitions and asymmetric links were untestable.  This
module is the pumba/iptables stand-in: a process-global rule table
consulted at the two network boundaries this codebase owns —

- ``InternalClient._do`` (every cluster-internal HTTP request: query
  fan-out, imports, anti-entropy block sync, resize copies, federation),
- the gossip transport's outgoing sends (UDP datagrams, TCP push/pull
  and oversized-message streams),

so a rule installed here behaves like a real network condition: an HTTP
``drop`` surfaces as a transport failure (ClientError with code None —
exactly what the executor's failure verdict keys on), a gossip ``drop``
silently loses the datagram, ``delay`` adds latency, ``error`` answers
with an HTTP status without the bytes ever leaving the process.

DETERMINISM is the design constraint: every probabilistic decision draws
from ONE seeded ``random.Random``, in intercept-call order, so the same
rule schedule against the same traffic sequence yields the same verdict
sequence (pinned by tests/test_faults.py).  Wall-clock never gates a
match — bounded rules use match COUNTS (``times``, ``after``), not
timers.

Rules are configured three ways, all equivalent:

- ``[faults]`` config section (``seed``, ``rules`` as spec strings),
- ``PILOSA_TPU_FAULTS`` / ``PILOSA_TPU_FAULTS_SEED`` env vars,
- ``POST /debug/faults`` at runtime (the chaos lanes' channel): body
  ``{"seed": N, "rules": [...]}`` REPLACES the table (and reseeds, so a
  re-POST of the same schedule replays the same verdicts); an empty
  rules list heals everything.

Rule spec (dict, or a "action k=v k=v" string):

  {"action": "drop",  "peer": "127.0.0.1:10102", "route": "/index/*",
   "prob": 0.5, "times": 3, "after": 10}
  {"action": "delay", "peer": "*", "ms": 50}
  {"action": "error", "peer": "*", "status": 503}
  {"action": "partition", "a": ["127.0.0.1:10101"],
   "b": ["127.0.0.1:10102"], "symmetric": true}

``peer``/``route`` are fnmatch globs over the destination "host:port"
and the request path ("gossip" for gossip traffic).  ``partition``
matches by GROUP: the plane knows its own addresses (Server.set_local —
node id + advertised HTTP + gossip endpoints), and traffic from a node
in group ``a`` to a destination in group ``b`` (and the reverse, unless
``symmetric`` is false — asymmetric links) is dropped.  One partition
body can therefore be POSTed verbatim to EVERY node of a cluster and
each enforces only its own side.  "localhost" normalizes to 127.0.0.1
so client URIs and gossip socket addresses compare equal.
"""

from __future__ import annotations

import fnmatch
import random
import threading
import time
from typing import Dict, List, Optional, Set

from ..util.stats import METRIC_FAULTS_INJECTED, REGISTRY

ACTIONS = ("drop", "delay", "error", "partition")

# Cap on injected delay: a mis-typed ms value must not wedge a reactor
# or the gossip probe loop for minutes.
MAX_DELAY_MS = 5000.0


def _norm(addr: str) -> str:
    """Normalize one endpoint string: scheme/path stripped, localhost
    unified with 127.0.0.1 — InternalClient URIs and gossip socket
    tuples must compare equal for one rule to cover both transports."""
    a = str(addr).strip()
    if "://" in a:
        a = a.split("://", 1)[1]
    a = a.split("/", 1)[0]
    return a.replace("localhost", "127.0.0.1")


class FaultRule:
    """One fault rule.  ``matched`` counts structural matches (peer/
    route/window), ``injected`` counts actual applications (after the
    probability draw) — GET /debug/faults exposes both so a chaos
    script can assert its rule actually fired."""

    __slots__ = (
        "action", "peer", "route", "prob", "times", "after",
        "delay_ms", "status", "a", "b", "symmetric",
        "matched", "injected",
    )

    def __init__(
        self,
        action: str,
        peer: str = "*",
        route: str = "*",
        prob: float = 1.0,
        times: int = 0,
        after: int = 0,
        delay_ms: float = 0.0,
        status: int = 503,
        a: Optional[List[str]] = None,
        b: Optional[List[str]] = None,
        symmetric: bool = True,
    ):
        if action not in ACTIONS:
            raise ValueError(
                f"fault rule action {action!r}: expected one of "
                f"{', '.join(ACTIONS)}"
            )
        self.action = action
        self.peer = _norm(peer) if peer != "*" else "*"
        self.route = route
        self.prob = float(prob)
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"fault rule prob {prob!r}: expected [0, 1]")
        self.times = int(times)
        self.after = int(after)
        self.delay_ms = min(float(delay_ms), MAX_DELAY_MS)
        self.status = int(status)
        self.a: Set[str] = {_norm(x) for x in (a or [])}
        self.b: Set[str] = {_norm(x) for x in (b or [])}
        if action == "partition" and not (self.a and self.b):
            raise ValueError(
                "fault rule partition: both 'a' and 'b' groups required"
            )
        self.symmetric = bool(symmetric)
        self.matched = 0
        self.injected = 0

    def _match_structural(self, peer: str, route: str, local: Set[str]) -> bool:
        if self.action == "partition":
            # Enforce only this node's own side of the cut: traffic
            # from a-member to b-destination (and the reverse when
            # symmetric) is in the partition.
            if local & self.a and peer in self.b:
                return True
            return bool(self.symmetric and local & self.b and peer in self.a)
        if self.peer != "*" and not fnmatch.fnmatch(peer, self.peer):
            return False
        if self.route != "*" and not fnmatch.fnmatch(route, self.route):
            return False
        return True

    def to_dict(self) -> dict:
        d = {
            "action": self.action,
            "matched": self.matched,
            "injected": self.injected,
        }
        if self.action == "partition":
            d["a"] = sorted(self.a)
            d["b"] = sorted(self.b)
            d["symmetric"] = self.symmetric
        else:
            d["peer"] = self.peer
            d["route"] = self.route
        if self.prob != 1.0:
            d["prob"] = self.prob
        if self.times:
            d["times"] = self.times
        if self.after:
            d["after"] = self.after
        if self.action == "delay":
            d["ms"] = self.delay_ms
        if self.action == "error":
            d["status"] = self.status
        return d


def parse_rule(spec) -> FaultRule:
    """A rule from a dict (the POST /debug/faults body) or a compact
    "action k=v ..." spec string (the [faults] config / env dialect;
    list values use ``|`` separators: ``partition a=h:p1|h:p2 b=h:p3``).
    Raises ValueError naming the offending spec — Server construction
    calls this fail-fast."""
    if isinstance(spec, FaultRule):
        return spec
    if isinstance(spec, str):
        parts = spec.split()
        if not parts:
            raise ValueError("empty fault rule spec")
        d: dict = {"action": parts[0]}
        for tok in parts[1:]:
            if "=" not in tok:
                raise ValueError(
                    f"fault rule {spec!r}: expected key=value, got {tok!r}"
                )
            k, _, v = tok.partition("=")
            d[k] = v.split("|") if k in ("a", "b") else v
        spec = d
    if not isinstance(spec, dict):
        raise ValueError(f"fault rule {spec!r}: expected dict or string")
    d = dict(spec)
    try:
        rule = FaultRule(
            action=d.pop("action"),
            peer=d.pop("peer", "*"),
            route=d.pop("route", "*"),
            prob=float(d.pop("prob", 1.0)),
            times=int(d.pop("times", 0)),
            after=int(d.pop("after", 0)),
            delay_ms=float(d.pop("ms", d.pop("delay-ms", 0.0))),
            status=int(d.pop("status", 503)),
            a=d.pop("a", None),
            b=d.pop("b", None),
            symmetric=str(d.pop("symmetric", True)).lower()
            not in ("false", "0", "no"),
        )
    except KeyError as e:
        raise ValueError(f"fault rule {spec!r}: missing {e}") from None
    if d:
        # A misspelled key ("per=...") must die here, not silently
        # degenerate into a match-everything rule that drops ALL
        # traffic — the fail-fast contract the Server validation
        # advertises.
        raise ValueError(
            f"fault rule {spec!r}: unknown key(s) {sorted(d)}"
        )
    return rule


class FaultPlane:
    """The process-global rule table.  ``active`` is read lock-free on
    the hot path — every internal request and gossip datagram passes
    through intercept(), and the no-rules case must cost one attribute
    read."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.seed = int(seed)
        self._rnd = random.Random(self.seed)
        self.rules: List[FaultRule] = []
        self.local: Set[str] = set()
        self.active = False

    def set_local(self, addrs) -> None:
        """This node's own identity set (node id + advertised HTTP +
        gossip "host:port") — what partition-group membership tests
        against."""
        with self._lock:
            self.local = {_norm(a) for a in addrs}

    def configure(self, rules, seed: Optional[int] = None) -> None:
        """REPLACE the rule table (and reseed — a re-POST of the same
        schedule replays the same verdict sequence).  Raises ValueError
        on any bad spec without touching the installed table."""
        parsed = [parse_rule(r) for r in (rules or [])]
        with self._lock:
            if seed is not None:
                self.seed = int(seed)
            self._rnd = random.Random(self.seed)
            self.rules = parsed
            self.active = bool(parsed)

    def clear(self) -> None:
        self.configure([])

    def intercept(
        self, peer: str, route: str = "", transport: str = "http"
    ) -> Optional[FaultRule]:
        """The boundary hook: first rule that matches AND passes its
        probability draw wins.  Returns the rule (caller applies the
        action) or None.  ``delay`` is applied HERE (the sleep), so
        gossip and client callers share one implementation; drop/error
        verdicts are returned for the caller to surface in its own
        idiom."""
        if not self.active:
            return None
        peer = _norm(peer)
        with self._lock:
            verdict = None
            for rule in self.rules:
                if transport == "serve":
                    # INBOUND request interception (the served side of
                    # the HTTP handler) is strictly opt-in: only rules
                    # that name peer="serve" apply, and only the
                    # delay/error actions make sense there — a blanket
                    # peer="*" chaos rule must keep meaning "outbound
                    # links", or every existing drill would take its own
                    # control plane down.  ("serve" can never collide
                    # with a real host:port peer.)
                    if rule.peer != "serve" or rule.action not in (
                        "delay", "error",
                    ):
                        continue
                elif rule.peer == "serve":
                    continue  # serve-only rules never match outbound
                elif transport == "gossip" and rule.action in (
                    "delay", "error",
                ):
                    # Gossip honors drop/partition only: SWIM has no
                    # status channel, and sleeping the probe loop would
                    # fault the PROBER, not the link.
                    continue
                if not rule._match_structural(peer, route, self.local):
                    continue
                rule.matched += 1
                if rule.after and rule.matched <= rule.after:
                    continue
                if rule.times and rule.injected >= rule.times:
                    continue
                if rule.prob < 1.0 and self._rnd.random() >= rule.prob:
                    continue
                rule.injected += 1
                verdict = rule
                break
        if verdict is None:
            return None
        REGISTRY.inc(METRIC_FAULTS_INJECTED, action=verdict.action)
        if verdict.action == "delay":
            time.sleep(verdict.delay_ms / 1000.0)
            return None  # delay applied; the request proceeds
        return verdict

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "active": self.active,
                "local": sorted(self.local),
                "rules": [r.to_dict() for r in self.rules],
            }


# The process-global plane: Server stamps identity + config rules onto
# it, InternalClient and the gossip transport consult it, and the
# /debug/faults endpoint mutates it at runtime.
PLANE = FaultPlane()
