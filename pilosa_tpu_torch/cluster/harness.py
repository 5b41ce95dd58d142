"""An in-process cluster of port nodes, the port of ``tests/harness.py``
(the reference's ``test.MustRunCluster``, test/pilosa.go:298-355).

``run_cluster(tmp_path, n, replica_n, device=...)`` opens ``n`` real
``Server``s in this process, each with its holder, translate store, engine
and HTTP listener on an ephemeral loopback port, and joins them into one
cluster with a static membership (no gossip), as the reference's cluster
tests do.  Node ``i`` is ``node{i}``; node 0 is the coordinator.  Tests pass
``device="cpu"``; with no device each node runs on the card.
"""

from __future__ import annotations

from typing import List

from ..config import Config
from ..net.client import InternalClient
from ..server import Server
from .cluster import Cluster, Node


class ClusterHarness:
    def __init__(self, servers: List[Server]):
        self.servers = servers

    def __getitem__(self, i: int) -> Server:
        return self.servers[i]

    def __len__(self):
        return len(self.servers)

    def client(self, i: int = 0) -> InternalClient:
        s = self.servers[i]
        return InternalClient(f"{s.scheme}://localhost:{s.port}",
                              tls_skip_verify=s.config.tls_skip_verify)

    def close(self):
        for s in self.servers:
            s.close()


def run_cluster(tmp_path, n: int, replica_n: int = 1, tls=None, device=None,
                configure=None) -> ClusterHarness:
    """``tls=(certfile, keyfile)`` boots an HTTPS cluster with skip-verify
    internal clients; ``configure(cfg, i)`` may set node ``i``'s config
    before it opens."""
    servers: List[Server] = []
    try:
        for i in range(n):
            cfg = Config()
            cfg.data_dir = str(tmp_path / f"node{i}")
            cfg.bind = "localhost:0"
            if tls is not None:
                cfg.tls_certificate, cfg.tls_key = tls
                cfg.tls_skip_verify = True
            if configure is not None:
                configure(cfg, i)
            srv = Server(cfg, device=device)
            srv.node_id = f"node{i}"
            srv.open(port_override=0)
            servers.append(srv)
    except BaseException:
        for srv in servers:
            srv.close()
        raise
    nodes = [Node(s.node_id, f"{s.scheme}://localhost:{s.port}", is_coordinator=(i == 0))
             for i, s in enumerate(servers)]
    for i, srv in enumerate(servers):
        cluster = Cluster(node=nodes[i], replica_n=replica_n, path=srv.data_dir,
                          client_factory=srv._make_client, logger=srv.logger,
                          journal=srv.journal)
        cluster.nodes = sorted([nodes[j] for j in range(n)], key=lambda nd: nd.id)
        cluster.holder = srv.holder
        cluster.state = "NORMAL"
        srv.cluster = cluster
        srv.api.attach_cluster(cluster, nodes[i])
    return ClusterHarness(servers)
