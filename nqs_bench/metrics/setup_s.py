"""setup_s (host clock): process start to the first timed step: imports, the
kernel library's load (its nvcc build on a checkout's first run), the
entry's build and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
