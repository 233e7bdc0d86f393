"""Images of every untraced train step of the window over the window's time,
to a final synchronize."""

UNIT = "img/s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.rate if ctx.kind == "train" else None
