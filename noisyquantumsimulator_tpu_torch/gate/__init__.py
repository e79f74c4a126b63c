"""The CZ gate engine: planning, execution and fidelity read-out."""
