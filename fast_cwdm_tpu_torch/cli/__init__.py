"""Synthesis plumbing and the entry points: sample, complete_dataset,
sample_auto, convert_checkpoint, train."""
