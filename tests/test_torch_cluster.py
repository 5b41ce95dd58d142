"""The cluster on the port (``pilosa_tpu_torch/cluster``, the executor's
fan-out, replicated writes and resize) against the JAX package.

- Every case of tests/test_cluster.py runs against the port
  (``port_of``): the reference's test text with ``pilosa_tpu`` read as
  ``pilosa_tpu_torch``, its in-process clusters from the port's harness
  (``pilosa_tpu_torch.cluster.harness.run_cluster``) and every Server,
  Holder and engine on the CPU.  Fan-out, replicated writes, failure
  retry, resize on join (and its write fence, abort and completion
  tracking), the holder cleaner, weighted placement, reweigh on rejoin.
- A three-node port cluster beside a three-node reference cluster
  (tests/harness.run_cluster), both at two replicas, answering the same
  requests through every node alike: Count, TopN, Sum, Min/Max, Rows,
  GroupBy, Row, a Set through a non-owner read back from both owners,
  Clear, Store.
- A mixed cluster, one reference node and one port node with a static
  membership, answering Count and TopN as a two-node reference cluster
  does.

Counts are integers: exact agreement (tolerance 0)."""

import functools
import pathlib
import re
import types

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent


def port_of(name: str, extra=()) -> types.ModuleType:
    """tests/<name>.py with its package read as pilosa_tpu_torch: its
    clusters from the port's harness and its Servers, Holders and engines
    on the CPU.  ``extra`` holds (pattern, replacement) pairs for names the
    port spells differently."""
    src = (HERE / f"{name}.py").read_text()
    src = src.replace("from harness import run_cluster",
                      "from pilosa_tpu_torch.cluster.harness import run_cluster as _run_cluster")
    src = re.sub(r"\bpilosa_tpu\b", "pilosa_tpu_torch", src)
    src = src.replace(".api.mesh_engine", ".api.engine")
    src = re.sub(r"\bServer\((\w+)\)", r'Server(\1, device="cpu")', src)
    src = re.sub(r"\bHolder\(\)", 'Holder(device="cpu")', src)
    src = re.sub(r"\bHolder\(path=", 'Holder(device="cpu", path=', src)
    for pat, rep in extra:
        src = re.sub(pat, rep, src)
    mod = types.ModuleType(f"torch_port_of_{name}")
    mod.__file__ = str(HERE / f"{name}.py")
    exec(compile(src, f"<{name}.py on pilosa_tpu_torch>", "exec"), mod.__dict__)
    if "_run_cluster" in mod.__dict__:
        mod.run_cluster = functools.partial(mod._run_cluster, device="cpu")
    return mod


def export(mod, into: dict):
    """The module's tests and fixtures as this file's."""
    for k, v in vars(mod).items():
        if k.startswith("test_") or hasattr(v, "_pytestfixturefunction") or \
                type(v).__name__ == "FixtureFunctionDefinition":
            into[k] = v


export(port_of("test_cluster"), globals())


# -- the port's cluster beside the reference's ----------------------------------

SW = 1 << 20


def _load(client):
    rng = np.random.default_rng(3)
    client.create_index("i")
    client.create_field("i", "f")
    client.create_field("i", "g")
    client.create_field("i", "v", {"type": "int", "min": 0, "max": 1000})
    for shard in range(9):
        cols = [shard * SW + int(c) for c in rng.choice(5000, 300, replace=False)]
        rows = rng.integers(1, 8, len(cols)).tolist()
        client.import_bits("i", "f", shard, rows, cols)
        client.import_bits("i", "g", shard, rng.integers(0, 3, len(cols)).tolist(), cols)
        client.import_values("i", "v", shard, cols[:50], rng.integers(0, 1000, 50).tolist())


QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=0)))",
    "Count(Union(Row(f=2), Row(f=3), Row(g=2)))",
    "TopN(f, n=3)",
    "TopN(f, Row(g=1), n=4)",
    "TopN(f, Row(g=1), n=0)",
    "Sum(field=v)",
    "Min(field=v)",
    "Max(Row(f=4), field=v)",
    "Rows(field=f)",
    "GroupBy(Rows(field=f), Rows(field=g))",
    "Row(f=5)",
]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    from harness import run_cluster as jrun

    from pilosa_tpu_torch.cluster.harness import run_cluster as trun

    j = jrun(tmp_path_factory.mktemp("ref"), 3, replica_n=2)
    t = trun(tmp_path_factory.mktemp("port"), 3, replica_n=2, device="cpu")
    try:
        for h in (j, t):
            _load(h.client(0))
        yield j, t
    finally:
        j.close()
        t.close()


def _results(h, i, q, **kw):
    return h.client(i).query("i", q, **kw)["results"]


@pytest.mark.parametrize("q", QUERIES)
def test_same_answers_through_every_node(pair, q):
    j, t = pair
    want = _results(j, 0, q)
    for i in range(3):
        assert _results(t, i, q) == want, (q, i)
        assert _results(j, i, q) == want, (q, i)


def test_fan_out_reaches_the_peers(pair):
    j, t = pair
    before = [s.api.executor.remote_fanouts for s in t.servers]
    _results(t, 0, "Count(Intersect(Row(f=1), Row(g=0)))")
    assert t[0].api.executor.remote_fanouts > before[0]


def test_replicated_writes_as_the_reference(pair):
    """A Set through a node that owns no replica of the shard lands on
    both owners, in both packages; Clear and Store answer alike."""
    j, t = pair
    shard = next(s for s in range(9)
                 if "node1" not in [n.id for n in t[0].cluster.shard_nodes("i", s)])
    assert [n.id for n in t[0].cluster.shard_nodes("i", shard)] == \
        [n.id for n in j[0].cluster.shard_nodes("i", shard)]
    col = shard * SW + 77777
    for h in (j, t):
        assert _results(h, 1, f"Set({col}, f=7)") == [True]
        for n in h[0].cluster.shard_nodes("i", shard):
            i = int(n.id[4:])
            assert col in _results(h, i, "Row(f=7)", shards=[shard], remote=True)[0]["columns"]
    for q in (f"Clear({col}, f=7)", "Store(Row(g=2), f=9)", "Count(Row(f=9))",
              "Count(Row(f=7))"):
        assert _results(t, 2, q) == _results(j, 2, q), q


# -- one reference node and one port node ----------------------------------------


def test_mixed_cluster_answers_as_the_reference(tmp_path):
    """A static two-node cluster of one reference Server and one port
    Server (on the CPU) answers Count and TopN through either node as a
    two-node reference cluster does."""
    from harness import run_cluster as jrun

    from pilosa_tpu.cluster import Cluster as JCluster, Node as JNode
    from pilosa_tpu.config import Config as JConfig
    from pilosa_tpu.server import Server as JServer
    from pilosa_tpu_torch.cluster import Cluster as TCluster, Node as TNode
    from pilosa_tpu_torch.config import Config as TConfig
    from pilosa_tpu_torch.net.client import InternalClient
    from pilosa_tpu_torch.server import Server as TServer

    ref = jrun(tmp_path / "ref", 2, replica_n=1)
    servers = []
    try:
        for i, (cfg_cls, srv_cls, kw) in enumerate(((JConfig, JServer, {}),
                                                     (TConfig, TServer, {"device": "cpu"}))):
            cfg = cfg_cls()
            cfg.data_dir = str(tmp_path / f"mixed{i}")
            cfg.bind = "localhost:0"
            srv = srv_cls(cfg, **kw)
            srv.node_id = f"node{i}"
            srv.open(port_override=0)
            servers.append(srv)
        uris = [f"http://localhost:{s.port}" for s in servers]
        for i, (srv, cl_cls, node_cls) in enumerate(((servers[0], JCluster, JNode),
                                                     (servers[1], TCluster, TNode))):
            nodes = [node_cls(f"node{k}", uris[k], is_coordinator=(k == 0)) for k in range(2)]
            c = cl_cls(node=nodes[i], replica_n=1, path=srv.data_dir,
                       client_factory=srv._make_client, logger=srv.logger, journal=srv.journal)
            c.nodes = nodes
            c.holder = srv.holder
            c.state = "NORMAL"
            srv.cluster = c
            srv.api.attach_cluster(c, nodes[i])
        mixed = [InternalClient(u) for u in uris]
        for client in (ref.client(0), mixed[0]):
            _load(client)
        for q in ("Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(g=0)))",
                  "TopN(f, n=3)", "TopN(f, Row(g=1), n=4)"):
            want = ref.client(0).query("i", q)["results"]
            for c in mixed:
                assert c.query("i", q)["results"] == want, q
        # Both packages own shards here: the fan-out crossed packages.
        owners = {n.id for s in range(9) for n in servers[0].cluster.shard_nodes("i", s)}
        assert owners == {"node0", "node1"}
    finally:
        for s in servers:
            s.close()
        ref.close()


def test_translate_log_replicates_across_packages(tmp_path):
    """The translate log a primary serves (/internal/translate/data) is the
    same bytes in both packages, and a port replica applying a reference
    primary's log (``[translation] primary-url``) translates the same keys
    to the same ids and refuses new ones."""
    from pilosa_tpu.core.translate import TranslateFile as JTranslate
    from pilosa_tpu_torch.core.translate import ReadOnlyError
    from pilosa_tpu_torch.core.translate import TranslateFile as TTranslate

    j, t = JTranslate(str(tmp_path / "j.keys")), TTranslate(str(tmp_path / "t.keys"))
    for s in (j, t):
        s.open()
        s.translate_columns_to_uint64("i", [f"c{k}" for k in range(50)])
        s.translate_rows_to_uint64("i", "f", ["a", "b", "c"])
    assert t.reader(0) == j.reader(0) and t.reader(17) == j.reader(17)
    replica = TTranslate(str(tmp_path / "r.keys"), read_only=True)
    replica.open()
    data = j.reader(0)
    assert replica.apply_log(data[:40]) <= 40  # a cut entry waits for the rest
    replica.apply_log(j.reader(replica.size()))
    assert replica.size() == j.size()
    assert replica.translate_columns_to_uint64("i", ["c7", "c49"]) == \
        j.translate_columns_to_uint64("i", ["c7", "c49"])
    assert replica.translate_row_to_string("i", "f", 2) == "b"
    with pytest.raises(ReadOnlyError):
        replica.translate_columns_to_uint64("i", ["new"])
    for s in (j, t, replica):
        s.close()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_cluster_started_on_written_directories_routes_every_shard(tmp_path):
    """Where the port departs from the reference, pinned: a node tells each
    peer its NodeStatus (schema and available shards) once it serves
    (``Server._tell_status``).  Three nodes started
    on data directories written beforehand (each holding only the shards
    the port's placement gives it, the cluster's ``.topology`` and the
    node's ``.id``), gossip-joined, with anti-entropy an hour away, then
    answer a Count over every shard through every node, before any
    anti-entropy pass.  The reference learns a peer's shards only at that
    pass."""
    import json
    import time

    from pilosa_tpu_torch.cluster import Cluster, Node
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.core.holder import Holder
    from pilosa_tpu_torch.net.client import InternalClient
    from pilosa_tpu_torch.server import Server

    n_shards, ids = 6, ["n0", "n1", "n2"]
    nodes = [Node(nid, f"http://{nid}", i == 0) for i, nid in enumerate(ids)]
    placer = Cluster(nodes[0], replica_n=2)
    placer.nodes = list(nodes)
    owners = {sh: [n.id for n in placer.shard_nodes("i", sh)] for sh in range(n_shards)}
    cols = {sh: sh * (1 << 20) + np.arange(sh + 1) * 7 for sh in range(n_shards)}
    ports = [_free_port() for _ in ids]
    gports = [_free_port() for _ in ids]
    topology = [{"id": nid, "uri": f"http://localhost:{ports[i]}", "isCoordinator": i == 0,
                 "state": "READY", "devices": 1} for i, nid in enumerate(ids)]
    for i, nid in enumerate(ids):
        d = tmp_path / nid
        h = Holder(str(d), device="cpu")
        h.open()
        f = h.create_index("i").create_field("f")
        mine = [sh for sh in range(n_shards) if nid in owners[sh]]
        c = np.concatenate([cols[sh] for sh in mine])
        f.import_bulk(np.ones(c.size, dtype=np.int64), c)
        h.close()
        (d / ".id").write_text(nid)
        (d / ".topology").write_text(json.dumps({"nodes": topology}))
    servers = []
    try:
        for i, nid in enumerate(ids):
            cfg = Config()
            cfg.data_dir = str(tmp_path / nid)
            cfg.bind = f"localhost:{ports[i]}"
            cfg.cluster_replicas = 2
            cfg.cluster_coordinator = i == 0
            cfg.gossip_port = gports[i]
            cfg.gossip_seeds = [] if i == 0 else [f"127.0.0.1:{gports[0]}"]
            cfg.gossip_probe_interval = 0.1
            cfg.gossip_push_pull_interval = 0.3
            cfg.anti_entropy_interval = 3600.0
            servers.append(Server(cfg, device="cpu").open())
        want = sum(c.size for c in cols.values())
        clients = [InternalClient(f"http://localhost:{p}") for p in ports]
        deadline = time.monotonic() + 30.0
        got = None
        while time.monotonic() < deadline:
            got = [c.query("i", "Count(Row(f=1))")["results"][0] for c in clients]
            if got == [want] * len(ids):
                break
            time.sleep(0.1)
        assert got == [want] * len(ids)
        for s in servers:
            assert not s.journal.events(type="antientropy.start")
    finally:
        for s in servers:
            s.close()
