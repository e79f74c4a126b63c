"""Operators (host numpy) and the batched matrix exponential (torch + CUDA)."""
