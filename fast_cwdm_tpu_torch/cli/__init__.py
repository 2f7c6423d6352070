"""Synthesis plumbing and the sampling entry point."""
