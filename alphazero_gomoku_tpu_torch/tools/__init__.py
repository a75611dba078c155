"""Counterparts of the JAX repo's ``tools/``: the tensor-core rate probe
(``matmul_rate``); the arena tools (``compare_snapshots``, ``int8_ab``,
``cross_net_arena``, ``gumbel_ab``, ``reuse_ab``, ``kleaf_ab``,
``harvest_run``, ``strength_probe``) and the mirrored arena of two sides
they play through (``ab_arena``); and the latency floor of the tree
kernels (``latency_floor``), which has no counterpart there."""
