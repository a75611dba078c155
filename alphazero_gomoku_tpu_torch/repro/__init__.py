"""Counterparts of the JAX repo's ``repro/``: the width-1 slice write through
a 3-D scratch (``width1_slice_write``), and the tree kernels' envelope probes
on their shared core ``envelope`` (``bisect_batch512``, ``bisect_lockstep``,
``parent_probe``, ``parent_longrun``)."""
