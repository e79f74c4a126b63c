"""Named experiment parameter sets (counterpart of the reference's
`models/` package)."""
