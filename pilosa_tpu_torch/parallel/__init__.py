"""Device placement, the count kernels and the fused Count engine.

Submodules are imported where used: ``core`` imports ``mesh`` while
``engine`` imports ``core``.
"""
