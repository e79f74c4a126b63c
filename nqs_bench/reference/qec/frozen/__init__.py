"""A frozen copy of the port's host code that builds a BB code, its
memory-Z circuit and its detector error model (`ldpc`, `circuits`, `dem`)."""
