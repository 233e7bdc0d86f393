"""Mean device time of the decode head's forward a request."""

from port_bench import readers

UNIT = "ms"
LAYER = "head"
MOVES = "infer_img_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.mean_ms(ctx, "head", "infer")
