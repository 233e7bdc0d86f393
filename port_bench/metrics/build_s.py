"""Seconds of `build_train_state` or `build_model`, host clock to a
synchronize."""

UNIT = "s"
LAYER = "entry"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.build_s
