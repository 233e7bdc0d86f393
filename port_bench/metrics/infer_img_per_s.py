"""Crops of every untraced request of the window over the window's time."""

UNIT = "img/s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.rate if ctx.kind == "infer" else None
