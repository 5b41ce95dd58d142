"""pilosa_tpu_torch — the PyTorch/CUDA port of pilosa_tpu for one NVIDIA H100.

A package of its own beside ``pilosa_tpu`` (the JAX reference, which it
never imports).  This slice runs the system's main path: PQL Count trees
over dense or occupancy-guided block-sparse field stacks, counted on the
card by hand-written CUDA kernels (``csrc/``).  Entry points:
``core.Holder``, ``parallel.engine.TorchEngine`` and
``executor.Executor``; each runs on the card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
