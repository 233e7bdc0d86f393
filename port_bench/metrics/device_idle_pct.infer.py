"""100 minus the union of kernel, copy and set intervals over the traced span
of requests."""

from port_bench import readers

UNIT = "%"
LAYER = "device"
MOVES = "infer_img_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.idle_pct(ctx, "infer")
