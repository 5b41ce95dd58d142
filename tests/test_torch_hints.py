"""Every case of tests/test_hints.py run against the port
(``test_torch_cluster.port_of``): the reference's test text with
``pilosa_tpu`` read as ``pilosa_tpu_torch``, its clusters from the port's
harness and every Server and Holder on the CPU."""

from test_torch_cluster import export, port_of

export(port_of("test_hints"), globals())
