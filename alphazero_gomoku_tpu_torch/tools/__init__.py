"""Counterparts of the JAX repo's ``tools/``: the tensor-core rate probe
(``matmul_rate``); and the latency floor of the tree kernels
(``latency_floor``), which has no counterpart there."""
