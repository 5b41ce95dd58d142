"""The engine's host-lane error types (``pilosa_tpu/parallel/errors.py``).

A module of its own, so that the executor, the batcher and the fusion
planner import the types without the engine.  Every exception that asks
the executor to serve a call from its host lane derives from
``HostFallback``, and every fallback site of the executor catches that
one type, so a new reason to decline can never miss a site:

- ``UnsupportedLowering``: the call tree has no device lowering (an
  unported call, a bad argument, a tree past the kernels' limits);
- ``PeerlessMeshError`` and its subclass ``ResidencyMiss``: the stack (or
  the rows of it a query touches) is not on the card and does not fit the
  device budget whole; a promotion of the touched working set has been
  requested (``residency.py``) and the host tier answers meanwhile.

No other exception from the engine is caught, so a kernel fault surfaces.
"""


class HostFallback(Exception):
    """The engine declines a call; the executor's host lane serves it."""


class UnsupportedLowering(HostFallback):
    """The call tree has no device lowering here (an unported call, a
    missing field or row argument, or a tree past the kernels' limits)."""


class PeerlessMeshError(HostFallback, RuntimeError):
    """A collective cannot proceed across processes (the reference's
    multi-process mesh; the port's cluster is ROADMAP.md Queue 1 item 15).
    Kept as the base of ``ResidencyMiss``, as in the reference."""


class ResidencyMiss(PeerlessMeshError):
    """The query's field stack (or the rows it touches) is not on the card
    and would not fit the device budget whole: an asynchronous promotion of
    the touched working set has been requested, and the query is served
    from the host tier instead of blocking on an upload or admitting the
    stack past the budget (docs/residency.md).  A cold stack costs latency,
    never correctness."""

    def __init__(self, msg: str, key=None, resident_fraction: float = 0.0):
        super().__init__(msg)
        self.key = key
        self.resident_fraction = resident_fraction
