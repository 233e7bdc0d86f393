"""100 minus the union of kernel, copy and set intervals over the traced span
of train steps."""

from port_bench import readers

UNIT = "%"
LAYER = "device"
MOVES = "train_img_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.idle_pct(ctx, "train")
