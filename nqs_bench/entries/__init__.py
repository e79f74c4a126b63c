"""Adapters of the program's entries, one module a program entry; a mix
names its adapter by the module's file name. The harness, the fault tool
and the CPU tests learn everything about a cell from these functions, so a
cell of another kind (a decoder, a sampler) is added as a new adapter, with
no edit to the harness. Each module has:

  Program(config, traffic, device): builds the entry; `step(x)` runs one
      step on the mix's inputs x and returns its answers on the host;
  valid(out): the range check that fails a step;
  model(config): the plain reference model of the configuration (nothing
      of the program), which `check` takes;
  check(model, traffic, xs, outs, rng, device, control): the numbers that
      decide `correct`, each a dict key held to `limits/<cell>.json`, for
      the window's inputs xs (on the host: floats as float64, seeds as
      int64) and answers outs; with `control`, the control's numbers in the
      program's place; `rng` (seeded by the run) draws what is sampled;
  small(config, traffic) -> (config, traffic): the sizes at which a CPU
      test runs a cell (`tests/conftest.make_small_root`);
  FAULTS and planted(fault): the faults of `faults.FAULTS` that the
      program can have, and a context manager that plants one under the
      timed path (`faults.planted`, `calibrate.py --fault`).

The gate entries also have `SETTINGS`, the block of a configuration file
that they run under, and `reference(model, x, mode, device)`."""
