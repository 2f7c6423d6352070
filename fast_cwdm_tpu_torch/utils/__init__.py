"""Deterministic test utilities."""
