"""build_s (program_span): the benchmark's span around the entry's build in
set-up: the host plan (physics, Liouvillian, phase-frame generator, real
basis) and the constants' move to the device."""


def read(ctx):
    return ctx.spans.get("build_s")
