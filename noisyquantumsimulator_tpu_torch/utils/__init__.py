"""Numeric helpers shared across the port."""
