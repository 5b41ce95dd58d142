"""The single-node HTTP front end: the route table (``server.Handler``)
on the event-loop reactor (``aserver``) or the threaded oracle, its wire
formats (``wire``, ``proto``), admission control, ``InternalClient``, and
process mode (``procserver``, ``worker``, ``ipc``).

``Handler``, ``serve`` and ``InternalClient`` load on first use: a
process-mode worker imports this package and must not load the API (and
torch) with it."""

_LAZY = {"Handler": "server", "serve": "server", "InternalClient": "client"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(f"{__name__}.{mod}"), name)
