"""Utilities shared across the port: the pytree helpers."""
