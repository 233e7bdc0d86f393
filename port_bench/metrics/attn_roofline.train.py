"""Least time of the step's attention calls (forward and backward; fp32
products at the TF32 peak) over the device time of the `attention_*` and
`split_tf32` kernels in the traced steps."""

from port_bench import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.kernel_roofline(ctx, "attention", "train")
