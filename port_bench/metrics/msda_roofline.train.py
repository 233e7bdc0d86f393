"""Least time of the step's deformable attention calls (forward and backward,
from their shapes) over the device time of the `msda_*` kernels in the
traced steps."""

from port_bench import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.kernel_roofline(ctx, "msda", "train")
