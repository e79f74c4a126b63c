"""Adapters of the program's entries. Each module has `SETTINGS` (its block
in a configuration file), `Program` (builds the entry; `step(x)` runs one
step and returns its answers on the host), `valid(out)` (the range check
that fails a step), `reference(model, x, mode, device)` (the plain
reference's answers) and `check(model, traffic, xs, outs, rng, device,
control)` (the numbers that decide `correct`). A mix names its adapter by
this module's file name."""
