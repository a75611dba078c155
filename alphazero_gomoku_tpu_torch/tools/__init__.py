"""Counterparts of the JAX repo's ``tools/``: the tensor-core rate probe
(``matmul_rate``)."""
