"""The benchmark of ``alphazero_gomoku_tpu_torch``: self-play on one card.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``).  ``BENCHMARK.json`` at the
repo's root names the cells and metrics; the files they name are found by
name (``spec.py``).  The benchmark imports nothing of the JAX package and no
``jax``; ``program.py`` is its only module that imports the program, and
``reference/`` imports nothing of it.
"""
