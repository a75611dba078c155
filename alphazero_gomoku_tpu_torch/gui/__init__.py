"""Pygame GUI (board app + mirror-mode spectator) and the engine driver.

Counterpart of ``alphazero_gomoku_tpu/gui/``.
"""
