"""Every cluster case of tests/test_cluster_obs.py run against the port
(``test_torch_cluster.port_of``): the journal, /healthz and /readyz across
startup, gossip convergence and resize, the /cluster/metrics federation
(both nodes' series labeled by node id, a degraded node reported as a
scrape error) and anti-entropy's journaling, with the reference's test
text read as ``pilosa_tpu_torch``, its clusters from the port's harness and
its engines the port's TorchEngine on the CPU.  Left out, two cases of the
reference engine's own series that the port's engine does not publish:
the XLA compile-cache series (``pilosa_engine_compile_*``; the port's
kernels are built once by nvcc) and the HBM gauges
``pilosa_engine_resident_bytes`` / ``pilosa_engine_evicted_bytes`` (the
port reports residency as ``pilosa_engine_resident_block_fraction`` and in
/debug/vars; tests/test_torch_residency.py holds them).  The engine's
eviction journal with the query's trace id is kept."""

from test_torch_cluster import export, port_of

_ENGINE = (
    r"from pilosa_tpu_torch\.parallel import MeshEngine, make_mesh",
    "from pilosa_tpu_torch.parallel.engine import TorchEngine as _TorchEngine\n"
    "def MeshEngine(holder, mesh, **kw):\n"
    "    return _TorchEngine(holder, device='cpu', **kw)\n"
    "def make_mesh(n):\n"
    "    return None",
)
_mod = port_of("test_cluster_obs", extra=(_ENGINE,))
del _mod.test_engine_metrics_series_present_after_traffic  # XLA compile series
del _mod.test_engine_close_journals_shutdown_and_flushes_gauges  # HBM gauges
export(_mod, globals())
