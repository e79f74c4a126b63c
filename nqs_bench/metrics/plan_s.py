"""plan_s (program_span, s): the run's first nqs.plan span, the entry's host
plan (`gate/simulate.plan_cz_gate`) in set-up: the inside counterpart of
`build_s`, which adds the rest of the entry's build and the constants' move
to the device."""
from nqs_bench import program_spans


def read(ctx):
    v = program_spans.view(ctx)
    return None if v is None else program_spans.seconds(program_spans.first(v, program_spans.PLAN))
