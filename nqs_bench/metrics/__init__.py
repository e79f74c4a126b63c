"""One reader a metric: `read(ctx)` returns the metric's value, or None when
the run holds nothing to read it from (the harness then leaves it out).

ctx: root, cell, config, traffic (the cell's files), spans ({"build_s": s}),
setup_s, durations (host seconds of every step of the window), window_s,
attempted, and trace (None, or for `--trace 1`: events, device (start us,
end us, name, category) of every device activity, steps, inputs of the
traced steps, window_s of the traced steps on the host clock)."""
