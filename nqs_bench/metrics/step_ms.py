"""step_ms (host clock): the whole window over all the steps in it. A step
runs from drawing its inputs to its outputs on the host."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.attempted if ctx.attempted else None
