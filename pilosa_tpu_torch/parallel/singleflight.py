"""Request collapsing for identical concurrent read queries.

A copy of ``pilosa_tpu/parallel/singleflight.py``.  The reference serves
concurrent identical queries from goroutines over one shared mmap, so a
duplicate costs only CPU.  On the card every duplicate is a full launch
and a readback, so N clients asking the same TopN at once would pay N
launches for one answer.  This is the groupcache-style singleflight: the
first caller computes; concurrent callers with the same key wait and
share the result (errors propagate to every waiter; results are NOT
cached — the moment the flight lands, the next caller recomputes against
fresh data, so writes are never masked)."""

from __future__ import annotations

import threading
from typing import Callable, Dict


class _Flight:
    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None


class SingleFlight:
    # A flight that outlives this is wedged: fail the waiters rather
    # than hang their threads forever.
    WAIT_TIMEOUT = 300.0

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: Dict[tuple, _Flight] = {}
        # Telemetry (tests assert on shared counts).
        self.flights = 0
        self.shared = 0

    def do(self, key: tuple, fn: Callable):
        """Run ``fn()`` once per concurrent burst of callers with the
        same ``key``; every caller gets its result (or its exception)."""
        with self._lock:
            f = self._flights.get(key)
            if f is not None:
                self.shared += 1
                leader = False
            else:
                f = _Flight()
                self._flights[key] = f
                self.flights += 1
                leader = True
        if not leader:
            if not f.event.wait(self.WAIT_TIMEOUT):
                raise RuntimeError("singleflight wait timed out")
            if f.error is not None:
                raise f.error
            return f.result
        try:
            f.result = fn()
            return f.result
        except BaseException as e:
            f.error = e
            raise
        finally:
            with self._lock:
                self._flights.pop(key, None)
            f.event.set()
