"""The kv logger and deterministic test utilities."""
