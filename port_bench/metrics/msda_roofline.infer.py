"""Least time of a request's deformable attention calls (forward) over the
device time of the `msda_*` kernels in the traced requests."""

from port_bench import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "infer_img_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.kernel_roofline(ctx, "msda", "infer")
