"""Least time of an image's train-step work (3 forwards of the reference's
counted operations, each part at its stated dtype's peak) over the window's
time an image."""

from port_bench import readers

UNIT = "%"
LAYER = "model step"
MOVES = "train_img_per_s"
SOURCE = "host_clock"


def read(ctx):
    return readers.mfu(ctx, "train")
