"""Algorithms of the port (mirrors ``orion_tpu.algo``; ``tpu_bo`` so far)."""
