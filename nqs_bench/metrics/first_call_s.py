"""first_call_s (program_span, s): the host duration of the run's first
nqs.step span, the first warm-up step: the kernel library's load (its nvcc
build on a checkout's first run) and the first device calls."""
from nqs_bench import program_spans


def read(ctx):
    v = program_spans.view(ctx)
    return None if v is None else program_spans.seconds(program_spans.first(v, program_spans.STEP))
