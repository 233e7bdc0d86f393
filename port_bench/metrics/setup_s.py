"""Process start to the window's first step, less the time the correctness
check's own readings took."""

UNIT = "s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
