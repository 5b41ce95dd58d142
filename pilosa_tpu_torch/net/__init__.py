"""The single-node HTTP front end: the route table (``server.Handler``)
on the event-loop reactor (``aserver``) or the threaded oracle, its wire
formats (``wire``, ``proto``), admission control and ``InternalClient``."""

from .server import Handler, serve
from .client import InternalClient
