"""Checkpoints: the JAX package's ``.ckpt`` format, read and written."""
