"""The kv logger, device time and profiling tools, and deterministic test
utilities."""
