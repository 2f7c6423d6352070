"""Training: the step (AdamW, EMA, metrics), the loop, and the JAX
package's ``.ckpt`` format, read and written."""
