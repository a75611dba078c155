"""Counterparts of the JAX repo's ``repro/``: the width-1 slice write through
a 3-D scratch (``width1_slice_write``)."""
