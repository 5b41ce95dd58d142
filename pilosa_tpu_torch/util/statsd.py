"""StatsD backend for the StatsClient interface (``[metric] service =
statsd``); a copy of ``pilosa_tpu/util/statsd.py``.

Mirror of the reference's statsd/DataDog client (statsd/statsd.go:28-163):
UDP datagrams in the DogStatsD format (``name:value|type|@rate|#tags``),
tag-scoped via with_tags, fire-and-forget.
"""

from __future__ import annotations

import socket
from typing import List, Optional

from .stats import StatsClient

DEFAULT_HOST = "127.0.0.1:8125"


class StatsdClient(StatsClient):
    def __init__(self, host: str = DEFAULT_HOST, prefix: str = "pilosa_tpu", _tags=None, _sock=None):
        self.prefix = prefix
        self._tags = _tags or []
        if _sock is None:
            h, _, p = (host or DEFAULT_HOST).rpartition(":")
            self._addr = (h or "127.0.0.1", int(p or 8125))
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        else:
            self._sock = _sock
            self._addr = getattr(_sock, "_statsd_addr", None)

    def with_tags(self, *tags: str) -> "StatsdClient":
        c = StatsdClient.__new__(StatsdClient)
        c.prefix = self.prefix
        c._tags = sorted(set(self._tags) | set(tags))
        c._sock = self._sock
        c._addr = self._addr
        return c

    def tags(self) -> List[str]:
        return list(self._tags)

    def _emit(self, name: str, value, typ: str, rate: float, extra_tags=None):
        tags = self._tags + list(extra_tags or [])
        msg = f"{self.prefix}.{name}:{value}|{typ}"
        if rate != 1.0:
            msg += f"|@{rate}"
        if tags:
            msg += "|#" + ",".join(tags)
        try:
            self._sock.sendto(msg.encode(), self._addr)
        except OSError:
            pass

    def count(self, name, value: int = 1, rate: float = 1.0, tags=None):
        self._emit(name, value, "c", rate, tags)

    def gauge(self, name, value: float, rate: float = 1.0):
        self._emit(name, value, "g", rate)

    def histogram(self, name, value: float, rate: float = 1.0):
        self._emit(name, value, "h", rate)

    def set(self, name, value: str, rate: float = 1.0):
        self._emit(name, value, "s", rate)

    def timing(self, name, value_seconds: float, rate: float = 1.0):
        # Callers pass SECONDS (the StatsClient contract); DogStatsD's
        # |ms type expects milliseconds — convert at this emit boundary.
        # Sub-millisecond timings keep their fraction (int() truncated a
        # 500 us timing to "0|ms", erasing the whole engine tier).
        ms = value_seconds * 1e3
        value = int(ms) if ms == int(ms) else round(ms, 3)
        self._emit(name, value, "ms", rate)

    def close(self):
        self._sock.close()
