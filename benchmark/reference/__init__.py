"""The plain reference the benchmark judges the program against.

Plain PyTorch only: it imports neither ``jax`` nor the JAX package nor
anything of the program (``alphazero_gomoku_tpu_torch``), and takes nothing
the program made.  ``games`` has the rules, ``net`` the quantized forward,
``search`` the searches, ``replay`` the comparison of a self-play call.
"""
