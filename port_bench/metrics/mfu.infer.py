"""Least time of a crop's forward over the window's time a crop."""

from port_bench import readers

UNIT = "%"
LAYER = "model step"
MOVES = "infer_img_per_s"
SOURCE = "host_clock"


def read(ctx):
    return readers.mfu(ctx, "infer")
