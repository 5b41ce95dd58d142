"""The port's seq gate (``pilosa_tpu_torch/parallel/seqgate.py``): every
case of tests/test_seqgate.py, the reference's test text run against the
port's copy (``port_of``).  Dense tickets in order, out-of-order arrivals
serialized, skips, a passed seq refused, a running head never skipped, a
stalled head force-skipped."""

from test_torch_cluster import export, port_of

export(port_of("test_seqgate"), globals())
