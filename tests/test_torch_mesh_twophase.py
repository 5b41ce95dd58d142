"""The two-phase collective handoff on the port (``API.mesh_collective_accept``
and ``Server._broadcast_dispatch``): every case of
tests/test_mesh_twophase.py, the reference's test text run against the port
(``port_of``) with a ``TorchEngine`` on the CPU in place of its
``MeshEngine`` over an 8-device mesh.

Accept registers without dispatching, commit replays, abort and expiry
drop, an unknown did is refused, the canonical shard axis is checked at
accept, the initiator sends accept then commit (or abort to the survivors
when a peer refuses), and a failing broadcast degrades every query kind to
the host lane's answer.  Counts are integers: exact agreement."""

from test_torch_cluster import export, port_of

_ENGINE = (
    (r"from pilosa_tpu_torch\.parallel import MeshEngine, make_mesh",
     "from pilosa_tpu_torch.parallel.engine import TorchEngine"),
    (r"from pilosa_tpu_torch\.parallel import MeshEngine\n", "\n"),
    (r"return make_mesh\(8\)", "return None"),
    (r"MeshEngine\((\w+), mesh\)", r'TorchEngine(\1, device="cpu")'),
    (r"mesh_engine=", "engine="),
    (r"\bapi\.mesh_engine\b", "api.engine"),
    (r'Holder\(str\(tmp_path / "(\w+)"\)\)', r'Holder(str(tmp_path / "\1"), device="cpu")'),
)

export(port_of("test_mesh_twophase", _ENGINE), globals())
